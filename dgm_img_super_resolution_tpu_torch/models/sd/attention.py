"""Attention blocks of the SD x4-upscaler UNet (counterpart of the JAX
package's ``models/sd/attention.py``), under the published diffusers names.

With ``use_flash``, self-attention of at least 1024 tokens goes through the
flash-attention kernel (``ops/kernels/flash_attention.py``), as the JAX
package routes it to its Pallas kernel; every other attention (the
cross-attentions to the 77 text tokens, shorter self-attentions, and all of
them without ``use_flash``) is the plain ``attention`` below, whose scores
stay in the input dtype. The modules here take JAX's default, off; the
UNet turns it on (``models/sd/unet.py``). Activations of ``Transformer2D`` are
NCHW; inside the blocks tokens are (B, L, C).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.ops.kernels.flash_attention import flash_attention

FLASH_MIN_TOKENS = 1024


def gn_groups(channels: int, preferred: int = 32) -> int:
    """Largest group count <= ``preferred`` that divides ``channels`` (32 on
    every published width, fewer on tiny test configs)."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Lq, H, D); k, v: (B, Lk, H, D) -> (B, Lq, H, D), plainly: the
    scores scaled in the input dtype, the softmax in float32."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Attention(nn.Module):
    """diffusers ``Attention``: bias-free q/k/v projections, ``to_out`` =
    [Linear, Dropout]."""

    def __init__(self, dim: int, heads: int, kv_dim: int | None = None, use_flash: bool = False):
        super().__init__()
        kv_dim = dim if kv_dim is None else kv_dim
        self.heads = heads
        self.use_flash = use_flash
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv_dim, dim, bias=False)
        self.to_v = nn.Linear(kv_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        context = x if context is None else context
        b, lq, c = x.shape
        lk = context.shape[1]
        hd = c // self.heads
        q = self.to_q(x).view(b, lq, self.heads, hd)
        k = self.to_k(context).view(b, lk, self.heads, hd)
        v = self.to_v(context).view(b, lk, self.heads, hd)
        # as the JAX package: only self-attention-sized kv takes the kernel
        flash = self.use_flash and lq == lk and lq >= FLASH_MIN_TOKENS
        out = flash_attention(q, k, v) if flash else attention(q, k, v)
        out = out.reshape(b, lq, c)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU, as diffusers and the JAX package


class FeedForward(nn.Module):
    """diffusers ``FeedForward``: ``net`` = [GEGLU, Dropout, Linear]."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """Pre-LN (eps 1e-5): attn1, which attends to the text states instead of
    itself when ``only_cross``; attn2, cross-attention; GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, cross_dim: int, only_cross: bool = False, use_flash: bool = False):
        super().__init__()
        self.only_cross = only_cross
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, cross_dim if only_cross else None, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_dim, use_flash)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x), context if self.only_cross else None)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6) -> Linear ``proj_in`` over the flattened pixels ->
    one transformer block (the published depth) -> Linear ``proj_out``, plus
    the input."""

    def __init__(self, ch: int, heads: int, cross_dim: int, only_cross: bool = False, use_flash: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(gn_groups(ch), ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, cross_dim, only_cross, use_flash)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = self.proj_out(y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)
