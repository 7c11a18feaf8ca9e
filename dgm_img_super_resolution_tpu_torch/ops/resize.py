"""Bicubic resize as two matrix products (counterpart of the JAX package's
``ops/resize.py:82-174`` and ``:219``).

Only the ``"torch"`` variant is ported: torch ``F.interpolate(mode='bicubic',
align_corners=True)`` semantics (cubic a=-0.75, no antialias, replicate
boundary), which the SRDiff serve uses for its x4 LR upsample. Each axis is a
dense ``(out_len, in_len)`` matrix built in float64 with numpy and applied in
float32. The MATLAB and PIL variants wait for a later slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with free parameter ``a``."""
    x = np.abs(x.astype(np.float64))
    x2 = x * x
    x3 = x2 * x
    f = ((a + 2.0) * x3 - (a + 3.0) * x2 + 1.0) * (x <= 1.0)
    f = f + (a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a) * ((x > 1.0) & (x <= 2.0))
    return f


def _matrix_torch(in_len: int, out_len: int) -> np.ndarray:
    """torch bicubic ``align_corners=True`` row-weight matrix (clamped edges)."""
    taps = 4
    i = np.arange(out_len, dtype=np.float64)
    src = i * ((in_len - 1) / (out_len - 1)) if out_len > 1 else np.zeros_like(i)
    base = np.floor(src).astype(np.int64)
    frac = src - base
    offs = np.arange(taps) - 1  # [-1, 0, 1, 2]
    cols = base[:, None] + offs[None, :]
    w = _cubic(frac[:, None] - offs[None, :].astype(np.float64), a=-0.75)
    idx = np.clip(cols, 0, in_len - 1)
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_len), taps), idx.reshape(-1)), w.reshape(-1))
    return mat


@functools.lru_cache(maxsize=64)
def resize_matrix(in_len: int, out_len: int, variant: str = "torch") -> np.ndarray:
    """Dense float32 ``(out_len, in_len)`` resize matrix for one axis."""
    if variant != "torch":
        raise NotImplementedError(f"resize variant {variant!r} is not ported yet")
    return _matrix_torch(in_len, out_len).astype(np.float32)


def resize(x: torch.Tensor, out_hw: tuple[int, int], variant: str = "torch") -> torch.Tensor:
    """Resize an NCHW tensor to ``out_hw`` with two float32 matrix products."""
    _, _, h, w = x.shape
    mh = torch.from_numpy(resize_matrix(h, out_hw[0], variant)).to(x.device)
    mw = torch.from_numpy(resize_matrix(w, out_hw[1], variant)).to(x.device)
    y = torch.matmul(mh, x.to(torch.float32))
    return torch.matmul(y, mw.t())


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour NCHW upsample (the RRDB up-path)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")
