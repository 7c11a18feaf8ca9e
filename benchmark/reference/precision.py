"""Where the plain references round.

The references compute in float32 with TF32 off (``float32``). Every conv,
linear layer and matrix product goes through the functions here, so that
the same code can also run in a lower precision (``computed_in``): their
inputs and weights rounded to bfloat16 (``bfloat16``), or to float8 e4m3
with one scale a tensor (``float8``, the control of a bfloat16 program),
the products and everything else still taken in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

MODES = ("float32", "bfloat16", "float8")
_mode = "float32"
E4M3_MAX = 448.0


@contextlib.contextmanager
def computed_in(mode: str):
    """Round the inputs of every conv and product to ``mode`` inside."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"precision {mode!r}, not one of {MODES}")
    prev, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = prev


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the current mode rounds an operand, in float32."""
    t = t.float()
    if _mode == "float32":
        return t
    if _mode == "bfloat16":
        return t.to(torch.bfloat16).float()
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _b(b):
    return None if b is None else b.float()


def conv2d(x, w, b=None, stride=1, padding=0):
    return F.conv2d(q(x), q(w), _b(b), stride, padding)


def conv_transpose2d(x, w, b=None, stride=1, padding=0):
    return F.conv_transpose2d(q(x), q(w), _b(b), stride, padding)


def linear(x, w, b=None):
    return F.linear(q(x), q(w), _b(b))


def einsum(eq: str, a, b):
    return torch.einsum(eq, q(a), q(b))


def matmul(a, b):
    return torch.matmul(q(a), q(b))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)
