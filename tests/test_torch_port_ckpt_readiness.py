"""File-gated readiness of the port for the real checkpoints (counterpart of
``tests/test_ckpt_readiness.py``).

The upstream weights are not in the repository. These tests skip unless
the files are present; once they are, import -> upscale -> ``Measure`` and
the SD inventory check run with no code change:

- ``DGMSR_REAL_CKPT``: the upstream ``model_ckpt_steps_*.ckpt``; default
  search ``checkpoints/model_ckpt_steps_*.ckpt`` under the repository root.
- ``DGMSR_SD_CKPT_DIR``: a diffusers ``stable-diffusion-x4-upscaler``
  checkout; default ``checkpoints/stable-diffusion-x4-upscaler``.

They run on the CUDA device when there is one, else on the CPU.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _find_srdiff_ckpt() -> str | None:
    p = os.environ.get("DGMSR_REAL_CKPT", "")
    if p and os.path.exists(p):
        return p
    hits = sorted(glob.glob(os.path.join(REPO, "checkpoints", "model_ckpt_steps_*.ckpt")))
    return hits[-1] if hits else None


def _find_sd_dir() -> str | None:
    p = os.environ.get("DGMSR_SD_CKPT_DIR", "")
    if p and os.path.isdir(p):
        return p
    d = os.path.join(REPO, "checkpoints", "stable-diffusion-x4-upscaler")
    return d if os.path.isdir(os.path.join(d, "unet")) else None


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _load_pair(scale: int = 4, size: int = 160):
    """(lr, hr_u8) from a smooth synthetic natural-like image."""
    from dgm_img_super_resolution_tpu_torch.ops.resize import imresize

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    hr = np.stack([np.sin(7 * yy + 3 * xx), np.cos(5 * xx * yy + 1.0), np.sin(11 * xx)], -1)
    hr = ((hr * 0.5 + 0.5) * 255).round().astype(np.uint8)
    return imresize(hr, scale=1.0 / scale), hr


srdiff_ckpt = pytest.mark.skipif(
    _find_srdiff_ckpt() is None,
    reason="real SRDiff checkpoint not present (set DGMSR_REAL_CKPT or put model_ckpt_steps_*.ckpt under "
           "checkpoints/)")
sd_ckpt = pytest.mark.skipif(
    _find_sd_dir() is None,
    reason="SD x4-upscaler checkout not present (set DGMSR_SD_CKPT_DIR or put a diffusers checkout under "
           "checkpoints/stable-diffusion-x4-upscaler)")


@srdiff_ckpt
def test_srdiff_real_ckpt_import_sample_measure():
    from dgm_img_super_resolution_tpu_torch.ckpt.torch_import import import_srdiff_checkpoint
    from dgm_img_super_resolution_tpu_torch.core.config import set_hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.metrics import Measure

    params, step = import_srdiff_checkpoint(_find_srdiff_ckpt(), strict=True)
    assert step > 0, "the upstream checkpoint carries a global_step"
    hp = set_hparams("")
    pipe = SRDiffPipeline(hp, params=params, device=_device())
    lr, hr = _load_pair()
    sr_u8 = (np.clip(pipe.upscale(lr), 0, 1) * 255).round().astype(np.uint8)
    assert sr_u8.shape == hr.shape
    res = Measure(device=_device()).measure(sr_u8, hr, lr, hp["sr_scale"])
    assert np.isfinite([res["psnr"], res["ssim"], res["lr_psnr"]]).all(), res
    # a trained x4 model on smooth content (the reference reports ~26-29 dB on DIV2K)
    assert res["psnr"] > 20.0, res
    assert res["ssim"] > 0.5, res


@srdiff_ckpt
def test_srdiff_real_ckpt_op_point_revalidation():
    from dgm_img_super_resolution_tpu_torch.ckpt.torch_import import import_srdiff_checkpoint
    from dgm_img_super_resolution_tpu_torch.core.config import set_hparams
    from dgm_img_super_resolution_tpu_torch.validation import validate_operating_point

    params, _ = import_srdiff_checkpoint(_find_srdiff_ckpt(), strict=True)
    lr, hr = _load_pair(size=128)
    res = validate_operating_point(set_hparams(""), params, [(lr, hr)], device=_device())
    assert np.isfinite(res["delta_db"])
    # a gate at 10x the warning's tolerance: a whole dB means the recorded
    # operating point is wrong for the real weights
    assert res["delta_db"] <= 1.0, res


@sd_ckpt
def test_sd_inventory_matches_real_state_dict():
    from dgm_img_super_resolution_tpu_torch.ckpt import sd_inventory as inv
    from dgm_img_super_resolution_tpu_torch.ckpt.sd_import import _read_state_dict

    d = _find_sd_dir()
    for sub, inv_fn in (("unet", inv.unet_state_dict_shapes), ("vae", inv.vae_state_dict_shapes),
                        ("text_encoder", inv.text_encoder_state_dict_shapes)):
        sd = _read_state_dict(os.path.join(d, sub))
        real = {k: tuple(v.shape) for k, v in sd.items() if k not in inv.IGNORABLE_KEYS}
        want = {k: tuple(s) for k, s in inv_fn().items()}
        assert not sorted(set(want) - set(real)), f"{sub}: inventory keys absent from the files"
        assert not sorted(set(real) - set(want)), f"{sub}: keys of the files absent from the inventory"
        mismatched = {k: (want[k], real[k]) for k in want if want[k] != real[k]}
        assert not mismatched, f"{sub}: shape mismatches {dict(list(mismatched.items())[:10])}"


@sd_ckpt
def test_sd_real_pipeline_tiny_upscale():
    from dgm_img_super_resolution_tpu_torch.ckpt.sd_import import load_sd_x4_pipeline

    pipe = load_sd_x4_pipeline(_find_sd_dir(), device=_device())
    img = (np.random.default_rng(0).random((32, 32, 3)) * 255).astype(np.uint8)
    out = pipe("a photo", img, num_inference_steps=3)
    assert out.shape[-3:] == (128, 128, 3)
    assert np.isfinite(out).all()
