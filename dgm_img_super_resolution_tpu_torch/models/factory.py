"""Model factory: Hparams -> SRDiff model stack (counterpart of the JAX
package's ``models/factory.py``), plus a seeded random init."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.device import compute_dtype
from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import GaussianDiffusion
from dgm_img_super_resolution_tpu_torch.diffusion.schedule import make_schedule
from dgm_img_super_resolution_tpu_torch.models.rrdb import RRDBNet
from dgm_img_super_resolution_tpu_torch.models.unet import Unet


def build_unet(hp: Hparams) -> Unet:
    return Unet(
        dim=hp["hidden_size"],
        out_dim=3,
        dim_mults=hp.unet_dim_mults_tuple,
        cond_dim=hp["rrdb_num_feat"],
        rrdb_num_block=hp["rrdb_num_block"],
        sr_scale=hp["sr_scale"],
        use_attn=hp["use_attn"],
        res=hp["res"],
        up_input=hp["up_input"],
        groups=hp["gn_groups"],
        dtype=compute_dtype(hp),
    )


def build_rrdb(hp: Hparams) -> RRDBNet:
    # gc = nf // 2 is the upstream SRDiff instantiation convention.
    return RRDBNet(
        out_nc=3,
        nf=hp["rrdb_num_feat"],
        nb=hp["rrdb_num_block"],
        gc=hp["rrdb_num_feat"] // 2,
        sr_scale=hp["sr_scale"],
        dtype=compute_dtype(hp),
    )


def build_srdiff(hp: Hparams) -> GaussianDiffusion:
    schedule = make_schedule(
        timesteps=hp["timesteps"],
        beta_schedule=hp["beta_schedule"],
        beta_s=hp["beta_s"],
        beta_start=hp.get("beta_start", 1e-4),
        beta_end=hp["beta_end"],
        res=hp["res"],
    )
    return GaussianDiffusion(
        build_unet(hp),
        build_rrdb(hp) if hp["use_rrdb"] else None,
        schedule,
        res=hp["res"],
        res_rescale=hp["res_rescale"],
        clip_input=hp["clip_input"],
    )


@torch.no_grad()
def init_srdiff_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in place: LeCun-normal weights (std 1/sqrt(fan_in),
    as the JAX package's convs and dense layers) and uniform biases in
    +-1/sqrt(fan_in). Deterministic for a seed on any device."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            continue
        w = mod.weight
        # ConvTranspose2d keeps (C_in, C_out, kh, kw): its fan-in is C_in * kh * kw
        if isinstance(mod, nn.ConvTranspose2d):
            fan_in = w.shape[0] * w[0, 0].numel()
        else:
            fan_in = w[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        w.copy_(torch.randn(w.shape, generator=g) * bound)
        if mod.bias is not None:
            mod.bias.copy_((torch.rand(mod.bias.shape, generator=g) * 2 - 1) * bound)
    return model
