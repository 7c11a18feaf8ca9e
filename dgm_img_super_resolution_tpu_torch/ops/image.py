"""Image value-range conversion (counterpart of the JAX package's
``ops/image.py:26-36``). Tiles and patches are not ported yet."""

from __future__ import annotations

import numpy as np
import torch


def uint8_to_pm1(x) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return torch.as_tensor(x).to(torch.float32) / 127.5 - 1.0


def pm1_to_uint8(x) -> np.ndarray:
    """[-1, 1] float -> uint8 [0, 255] with round-half-to-even (the
    reference's ``np.round`` convention)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    y = (np.asarray(x, dtype=np.float64) + 1.0) * 127.5
    return np.round(np.clip(y, 0, 255)).astype(np.uint8)
