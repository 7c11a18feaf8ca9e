"""The random draws of a training loss, for a batch that may be some rows
of a larger one.

A loss draws its timesteps and noise with :func:`randint`, :func:`randn`
and :func:`normal_like` from ``generator``: a ``torch.Generator``, None
(torch's default generator) or a :class:`RowDraws`. A ``RowDraws`` draws
for the whole global batch from its generator and keeps its rows of the
result, so that every rank of a data-parallel run draws, for each row, the
number that one process would draw for it (``train/trainer.py`` wraps its
generator so when it runs a rank's rows). Otherwise the draws are torch's
own calls, unchanged.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class RowDraws(NamedTuple):
    """``generator``'s draws for a global batch of ``rows.total`` rows,
    sliced to ``rows`` (a ``parallel.mesh.Rows``: ``total`` and ``take``)."""

    generator: torch.Generator | None
    rows: Any


def _split(generator, shape):
    """(the torch generator, the shape to draw, what to keep of it)."""
    shape = tuple(shape)
    if isinstance(generator, RowDraws):
        return generator.generator, (generator.rows.total,) + shape[1:], generator.rows.take
    return generator, shape, None


def randint(high: int, shape, generator, device) -> torch.Tensor:
    """Integers in [0, high) of ``shape``, on the generator's device (else
    ``device``)."""
    g, s, take = _split(generator, shape)
    out = torch.randint(0, high, s, generator=g, device=g.device if g is not None else device)
    return out if take is None else take(out)


def randn(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    g, s, take = _split(generator, shape)
    out = torch.randn(s, generator=g, device=device, dtype=dtype)
    return out if take is None else take(out)


def normal_like(x: torch.Tensor, generator) -> torch.Tensor:
    """N(0, 1) float32 in ``x``'s shape and memory format (channels_last on
    the card), filled in memory order as ``normal_`` fills it."""
    g, s, take = _split(generator, x.shape)
    if take is None:
        return torch.empty_like(x, dtype=torch.float32).normal_(generator=g)
    fmt = (torch.channels_last if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return take(torch.empty(s, dtype=torch.float32, device=x.device, memory_format=fmt).normal_(generator=g))
