"""He-normal re-init and weight norm of the UNet (counterpart of the JAX
package's ``models/param_transforms.py``).

- ``weight_init: true``: :func:`kaiming_init` re-draws every conv, transposed
  conv and linear weight He-normal (std sqrt(2 / fan_in), as the reference's
  ``initialize_weights``, ``model.py:78-95``) and zeroes every bias of the
  module, GroupNorm's included, as JAX's ``zero_bias``.
- ``use_wn: true``: :func:`apply_weight_norm` puts a parametrization on each
  such weight, w = g * v / (||v|| + 1e-12) with the norm over every axis
  but the output channel's (dim 0 of Conv2d and Linear, dim 1 of
  ConvTranspose2d), so that the optimizer sees (g, v) as JAX's
  ``wn_split`` pairs and the forward the merged kernel. torch's own
  ``weight_norm`` divides by the bare norm; this keeps JAX's eps. The
  parameters are ``<module>.parametrizations.weight.original0`` (g, shaped
  like the weight with size 1 on every axis but the output one) and
  ``original1`` (v). :func:`remove_weight_norm` merges them back once (the
  reference's ``remove_weight_norm``, ``model.py:849-856``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

WN_EPS = 1e-12
LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _out_dim(mod: nn.Module) -> int:
    return 1 if isinstance(mod, nn.ConvTranspose2d) else 0


@torch.no_grad()
def kaiming_init(module: nn.Module, seed: int = 0, scale: float = 1.0) -> nn.Module:
    """He-normal weights scaled by ``scale``, zero biases, in place."""
    from dgm_img_super_resolution_tpu_torch.models.factory import fan_in

    g = torch.Generator().manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, LAYERS):
            std = scale * math.sqrt(2.0 / fan_in(mod))
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) * std)
        bias = getattr(mod, "bias", None)
        if isinstance(bias, torch.Tensor):
            bias.zero_()
    return module


class WeightNorm(nn.Module):
    """w = g * v / (||v|| + eps), the norm per output channel along ``dim``."""

    def __init__(self, dim: int, eps: float = WN_EPS):
        super().__init__()
        self.dim, self.eps = dim, eps

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        axes = [a for a in range(v.ndim) if a != self.dim]
        return v.square().sum(dim=axes, keepdim=True).sqrt()

    def forward(self, g, v):
        return g * v / (self._norm(v) + self.eps)

    def right_inverse(self, w):
        return self._norm(w), w


def apply_weight_norm(module: nn.Module) -> nn.Module:
    """Weight norm on every conv, transposed conv and linear weight of
    ``module``, in place (JAX ``wn_split``)."""
    for mod in list(module.modules()):
        if isinstance(mod, LAYERS) and not parametrize.is_parametrized(mod, "weight"):
            parametrize.register_parametrization(mod, "weight", WeightNorm(_out_dim(mod)))
    return module


def remove_weight_norm(module: nn.Module) -> nn.Module:
    """Merge every weight-norm pair into its weight, in place (JAX ``wn_merge``)."""
    for mod in list(module.modules()):
        if parametrize.is_parametrized(mod, "weight"):
            parametrize.remove_parametrizations(mod, "weight", leave_parametrized=True)
    return module
