"""The backward of the CUDA conv regions (counterpart of the JAX package's
``jax.custom_vjp``s around them).

A region's forward is its kernel launch; its backward recomputes the region's
plain PyTorch version under ``torch.enable_grad()`` on detached inputs and
returns ``torch.autograd.grad`` of that with the incoming gradient: the JAX
``_bwd``s, which take ``jax.vjp`` of the reference composition. Nothing
changes for serving: with grad mode off (``torch.inference_mode()``,
``torch.no_grad()``) or no input that requires grad, :func:`region` calls the
launch directly.
"""

from __future__ import annotations

import torch


class Recompute(torch.autograd.Function):
    """``apply(launch, plain, *args)``: ``launch(*args)`` forward, the VJP of
    ``plain(*args)`` backward. ``args`` may hold ``None`` (an absent
    ``cond``) and non-tensors (``border``, ``mish``); those get ``None``
    gradients. A tuple result takes one incoming gradient per part, any of
    which may be ``None``."""

    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.other = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return launch(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = list(ctx.other)
        wanted = []
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(ctx.needs_input_grad[2 + i])
            if ctx.needs_input_grad[2 + i]:
                wanted.append(i)
        with torch.enable_grad():
            out = ctx.plain(*args)
        pairs = [(o, g) for o, g in zip(out if isinstance(out, tuple) else (out,), grads) if g is not None]
        out_grads = [None] * (2 + len(args))
        if pairs and wanted:
            got = torch.autograd.grad([o for o, _ in pairs], [args[i] for i in wanted],
                                      [g for _, g in pairs], allow_unused=True)
            for i, g in zip(wanted, got):
                out_grads[2 + i] = g
        return tuple(out_grads)


def region(launch, plain, *args):
    """``launch(*args)``, differentiable through ``plain`` when grad mode is
    on and some tensor argument requires grad; otherwise the bare launch."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return Recompute.apply(launch, plain, *args)
    return launch(*args)
