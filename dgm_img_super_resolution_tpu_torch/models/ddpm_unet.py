"""The from-scratch DDPM UNet (counterpart of the JAX package's
``models/ddpm_unet.py``; the reference's ``basic_diffusion`` capability).

NCHW, named as the flax modules (``time_mlp_0``, ``init_conv``,
``down_0_res1``, ``down_0_attn``, ``down_0_downsample``, ``mid_res1``,
``up_0_upsample``, ``final_res``, ``final_conv``). The ResnetBlocks,
Blocks, Downsample and Upsample are the SRDiff UNet's (``models/layers.py``)
with GroupNorm at ``groups=8``; the skip join is an explicit concatenation
before the up stages' first ResnetBlock, as in JAX. The GroupNorm and the
attention are plain PyTorch, as JAX runs them outside its Pallas kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.models.layers import (
    GN_EPS,
    Block,
    Downsample,
    ResnetBlock,
    Upsample,
    mish,
    sinusoidal_pos_emb,
)


class SelfAttention2D(nn.Module):
    """Pre-norm softmax self-attention over the pixel grid, residual: GroupNorm
    (min(8, C) groups) -> bias-free 1x1 to q, k, v (channels ordered (qkv,
    head, d)) -> softmax(q k^T / sqrt(d)) v -> 1x1 -> x + out."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(min(8, dim), dim, eps=GN_EPS)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.to_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        d = c // self.heads
        qkv = self.to_qkv(self.norm(x)).reshape(b, 3, self.heads, d, h * w)
        q, k, v = qkv.unbind(1)
        attn = (torch.einsum("bhdq,bhdk->bhqk", q, k) * d ** -0.5).softmax(dim=-1)
        out = torch.einsum("bhqk,bhdk->bhdq", attn, v).reshape(b, c, h, w)
        return x + self.to_out(out)


class DDPMUnet(nn.Module):
    """init conv + sinusoidal time MLP -> per level 2 ResnetBlocks,
    attention, Downsample -> mid ResnetBlock, attention, ResnetBlock -> per
    level [x || skip] into 2 ResnetBlocks, attention, Upsample -> Block ->
    1x1: the predicted noise."""

    def __init__(self, dim: int = 64, out_dim: int = 1, dim_mults: Sequence[int] = (1, 2, 4), groups: int = 8,
                 in_ch: int = 1):
        super().__init__()
        self.dim = dim
        dims = [dim * m for m in dim_mults]
        self.n_levels = len(dims)
        self.time_mlp_0 = nn.Linear(dim, dim * 4)
        self.time_mlp_1 = nn.Linear(dim * 4, dim)
        self.init_conv = nn.Conv2d(in_ch, dim, 3, padding=1)
        cin = dim
        for i, d in enumerate(dims):
            self.add_module(f"down_{i}_res1", ResnetBlock(cin, d, dim, groups))
            self.add_module(f"down_{i}_res2", ResnetBlock(d, d, dim, groups))
            self.add_module(f"down_{i}_attn", SelfAttention2D(d))
            if i < len(dims) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(d))
            cin = d
        self.mid_res1 = ResnetBlock(dims[-1], dims[-1], dim, groups)
        self.mid_attn = SelfAttention2D(dims[-1])
        self.mid_res2 = ResnetBlock(dims[-1], dims[-1], dim, groups)
        for i, d in enumerate(reversed(dims)):
            skip_c = dims[len(dims) - 1 - i]
            self.add_module(f"up_{i}_res1", ResnetBlock(cin + skip_c, d, dim, groups))
            self.add_module(f"up_{i}_res2", ResnetBlock(d, d, dim, groups))
            self.add_module(f"up_{i}_attn", SelfAttention2D(d))
            if i < len(dims) - 1:
                self.add_module(f"up_{i}_upsample", Upsample(d))
            cin = d
        self.final_res = Block(cin, dim, groups)
        self.final_conv = nn.Conv2d(dim, out_dim, 1)

    def forward(self, x, time):
        t = sinusoidal_pos_emb(time, self.dim).to(x.dtype)
        t = self.time_mlp_1(mish(self.time_mlp_0(t)))
        x = self.init_conv(x)
        skips = []
        for i in range(self.n_levels):
            x = getattr(self, f"down_{i}_res1")(x, t)
            x = getattr(self, f"down_{i}_res2")(x, t)
            x = getattr(self, f"down_{i}_attn")(x)
            skips.append(x)
            if i < self.n_levels - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
        x = self.mid_res2(self.mid_attn(self.mid_res1(x, t)), t)
        for i in range(self.n_levels):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"up_{i}_res1")(x, t)
            x = getattr(self, f"up_{i}_res2")(x, t)
            x = getattr(self, f"up_{i}_attn")(x)
            if i < self.n_levels - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
        return self.final_conv(self.final_res(x))
