"""Faults planted in the port underneath the timed path, which the check
has to report as not correct: a sampler step that returns its state
unchanged, half of the batch left out (its images the other half's), and
an answer altered where it is produced.

    with faults.planted("srdiff", "half_the_batch_left_out"):
        ...  # serve and check as a run does

The CPU tests plant each at tiny widths; ``calibrate.py --fault`` reads
one at a cell's own size on the card.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _srdiff() -> dict:
    from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    serve_fn, sr_out = SRDiffPipeline._serve_fn, SRDiffPipeline._sr_out

    def half_batch(self, x, gen, noise, as_uint8):
        keep = max(1, x.shape[0] // 2)
        head = (noise[0][:keep], {t: v[:keep] for t, v in noise[1].items()}) if noise is not None else None
        out = serve_fn(self, x[:keep], gen, head, as_uint8)
        return torch.cat([out] * (x.shape[0] // keep + 1))[: x.shape[0]]

    def altered(self, out, h, w, as_uint8):
        img = sr_out(self, out, h, w, as_uint8)
        return torch.cat([img[:1].flip(1), img[1:]])

    return {
        "step_returns_its_state": (GaussianDiffusion, "ddim_update", lambda self, x, *a, **k: x),
        "half_the_batch_left_out": (SRDiffPipeline, "_serve_fn", half_batch),
        "answer_altered": (SRDiffPipeline, "_sr_out", altered),
    }


def _sd() -> dict:
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline as Pipe

    decode = Pipe._decode

    def altered(self, x):
        img = decode(self, x)
        return torch.cat([img[:1].flip(2), img[1:]])

    return {
        "step_returns_its_state": (Pipe, "_update", lambda self, x, *a, **k: x),
        "answer_altered": (Pipe, "_decode", altered),
    }


def names(driver: str, batch: int) -> tuple[str, ...]:
    """The faults a cell served by ``driver`` at ``batch`` images a request
    can have."""
    if driver == "srdiff" and batch > 1:
        return ("step_returns_its_state", "half_the_batch_left_out", "answer_altered")
    return ("step_returns_its_state", "answer_altered")


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """The port with ``fault`` planted, for the pipeline of ``driver``, for
    as long as the block runs."""
    owner, attr, fn = (_srdiff() if driver == "srdiff" else _sd())[fault]
    with mock.patch.object(owner, attr, fn):
        yield
