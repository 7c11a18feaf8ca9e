"""Re-check the recorded fast-sampler operating point under given weights
(counterpart of the JAX package's ``validation.py``).

The operating point (``DDIM_OPERATING_POINT.json``) was chosen under
particular weights; once real weights are loaded it must be checked again
against the full ancestral chain under those weights.
:func:`validate_operating_point` runs both samplers on (LR, HR) pairs and
compares their mean PSNR against the HR images; ``dgmsr-torch test
--check-op-point`` and the file-gated readiness test call it.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

logger = logging.getLogger("dgm_img_super_resolution_tpu_torch.validation")

_DEFAULT_OP = {"sampler": "ddim", "steps": 20, "eta": 1.0, "enc_interval": 1}


def recorded_operating_point(record_path: str | None = None) -> dict:
    """The operating point recorded by the DDIM study, over the defaults
    (ddim20, eta 1, ``enc_interval`` 1) where the record is missing or
    unreadable."""
    record_path = record_path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "DDIM_OPERATING_POINT.json")
    op = dict(_DEFAULT_OP)
    try:
        with open(record_path) as f:
            rec = json.load(f).get("operating_point")
    except (OSError, ValueError, AttributeError):
        rec = None
    if rec:
        op.update(rec)
    return op


def validate_operating_point(hp, params: Mapping[str, torch.Tensor], pairs: Sequence[tuple[np.ndarray, np.ndarray]],
                             op: dict | None = None, tol_db: float = 0.1, record_path: str | None = None,
                             device: str | torch.device | None = None, generator: torch.Generator | None = None,
                             noise: Callable | None = None) -> dict:
    """Run the T-step ancestral chain and the recorded fast mode under
    ``params`` (a state dict) on every (lr, hr_u8) pair, HWC, lr uint8 or
    [-1, 1] float; compare their mean PSNR against the HR images and warn
    when the fast mode falls more than ``tol_db`` below the chain. Both
    samplers of image i take the same noise: ``noise(name, i)`` gives the
    hook of sampler ``name`` ("golden" or "op"), else both draw from one
    generator seeded by a draw from ``generator``."""
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure

    op = op or recorded_operating_point(record_path)
    golden_hp = hp.replace(sampler="ddpm", sample_timesteps=0, enc_interval=1)
    op_hp = hp.replace(
        sampler=op["sampler"],
        sample_timesteps=int(op["steps"]) if op["sampler"] == "ddim" else 0,
        ddim_eta=float(op.get("eta", 1.0)),
        enc_interval=int(op.get("enc_interval", 1)),
    )
    pipes = {"golden": SRDiffPipeline(golden_hp, params=params, device=device),
             "op": SRDiffPipeline(op_hp, params=params, device=device)}
    dev = pipes["golden"].device
    measure = Measure(device=dev)
    generator = generator or torch.Generator(device=dev).manual_seed(0)
    psnrs: dict[str, list[float]] = {"golden": [], "op": []}
    for i, (lr, hr_u8) in enumerate(pairs):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device).item())
        for name, pipe in pipes.items():
            if noise is None:
                out = pipe.upscale(lr, generator=torch.Generator(device=dev).manual_seed(seed))
            else:
                out = pipe.upscale(lr, noise=noise(name, i))
            u8 = np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
            psnrs[name].append(measure.psnr(u8, hr_u8))
    g = float(np.mean(psnrs["golden"]))
    o = float(np.mean(psnrs["op"]))
    delta = g - o
    result = {
        "operating_point": op,
        "ancestral_mean_psnr_vs_hr": round(g, 4),
        "op_mean_psnr_vs_hr": round(o, 4),
        "delta_db": round(delta, 4),
        "tol_db": tol_db,
        "within_tol": bool(delta <= tol_db),
        "n_images": len(list(pairs)),
    }
    if not result["within_tol"]:
        logger.warning("operating point %s drifts %.3f dB below the ancestral chain under these weights "
                       "(tol %.2f): re-run the DDIM operating-point study "
                       "(tools/torch_port_ddim_operating_point.py) and re-record DDIM_OPERATING_POINT.json",
                       op, delta, tol_db)
    return result
