"""Seeded random weights, made on the device in a few large calls.

The reference module, built on the ``meta`` device, names every parameter
and its shape (the program takes the same names). ``make`` draws one
normal stream for all of them from a generator on ``device`` seeded by
``seed``, in chunks of at most ``CHUNK`` elements, and gives each tensor
its own scale and offset by one multiply and one add a chunk; the result is
cast to ``dtype``, the type the program serves them in. The same seed on
the same device gives the same weights, so the reference, which runs after
the program is freed, draws them again.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn

CHUNK = 1 << 27

# (module, parameter name, parameter) -> (scale, offset): the normal draw's std and mean
Rule = Callable[[nn.Module, str, torch.Tensor], tuple[float, float]]


def fan_in(mod: nn.Module, p: torch.Tensor) -> int:
    """Inputs per output: ConvTranspose2d keeps (C_in, C_out, kh, kw)."""
    if isinstance(mod, nn.ConvTranspose2d):
        return p.shape[0] * p[0, 0].numel()
    return p[0].numel()


def lecun(mod: nn.Module, name: str, p: torch.Tensor) -> tuple[float, float]:
    """SRDiff's init: weights N(0, 1/fan_in), biases of the same variance
    as a uniform draw in +-1/sqrt(fan_in)."""
    if name == "bias":
        return 1.0 / math.sqrt(3.0 * fan_in(mod, mod.weight)), 0.0
    return 1.0 / math.sqrt(fan_in(mod, p)), 0.0


def sd_rule(mod: nn.Module, name: str, p: torch.Tensor) -> tuple[float, float]:
    """The SD pipeline's seeded init: biases N(0, 0.02), norm scales
    1 + N(0, 0.05), embedding tables N(0, 0.05), kernels N(0, 1/fan_in)."""
    if name == "bias":
        return 0.02, 0.0
    if p.dim() == 1:
        return 0.05, 1.0
    if isinstance(mod, nn.Embedding):
        return 0.05, 0.0
    return 1.0 / math.sqrt(p[0].numel()), 0.0


def make(module: nn.Module, seed: int, device, dtype: torch.dtype, rule: Rule,
         prefix: str = "") -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for every parameter of ``module`` (on any device,
    ``meta`` included), drawn on ``device`` and cast to ``dtype``."""
    specs = [(prefix + (f"{mn}." if mn else "") + pn, tuple(p.shape), *rule(m, pn, p))
             for mn, m in module.named_modules() for pn, p in m.named_parameters(recurse=False)]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out: dict[str, torch.Tensor] = {}
    i = 0
    while i < len(specs):
        j, n = i, 0
        while j < len(specs) and (n == 0 or n + math.prod(specs[j][1]) <= CHUNK):
            n += math.prod(specs[j][1])
            j += 1
        group = specs[i:j]
        counts = torch.tensor([math.prod(s[1]) for s in group], device=device)
        flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
        flat.mul_(torch.repeat_interleave(torch.tensor([s[2] for s in group], device=device), counts))
        flat.add_(torch.repeat_interleave(torch.tensor([s[3] for s in group], device=device), counts))
        flat = flat.to(dtype)
        off = 0
        for name, shape, _, _ in group:
            k = math.prod(shape)
            out[name] = flat[off: off + k].view(shape)
            off += k
        i = j
    return out
