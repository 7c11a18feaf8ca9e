"""SRDiff building blocks (counterpart of the JAX package's
``models/layers.py:41-58``, ``:208-248`` and ``:326-717``).

Modules are NCHW with PyTorch's parameter layouts and the reference
checkpoint's names (``block.1`` is the conv of a Block, ``mlp.1`` the time
Linear of a ResnetBlock, ``conv.0``/``conv.1`` the Upsample/Downsample
convs). Parameters stay float32; every forward casts them to the dtype of
its input, which is the compute dtype. ``LinearAttention``, GroupNorm and
``MultiheadAttention`` are off in the SRDiff config and not ported yet.

The kernel gates (``chain_eligible`` ... ``rowpack_eligible``) read the JAX
package's environment switches, with its defaults, at every forward, so one
A/B configuration sets both packages. They keep its switches and channel
conditions and drop its TPU tile conditions (H, W multiples of 8 or 16, W >=
128, the backend check): the CUDA kernels take any H, W >= 2. They do not
look at the device either, so the CPU runs the same routing through the
kernels' plain versions.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

_CHAIN_CHANNELS = (64,)


def _switch(name: str, default: str) -> bool:
    return os.environ.get(name, default).lower() not in ("", "0", "false")


def chain_channels() -> tuple[int, ...]:
    """ResnetBlock-pair widths routed to the chain kernels: ``DGMSR_CHAIN_C``
    (comma-separated), default 64. The port's chain kernels are built for
    C = 64 only: the JAX kernel's unpacked C >= 128 mode is not ported, so
    naming another width raises."""
    env = os.environ.get("DGMSR_CHAIN_C")
    chans = tuple(int(v) for v in env.split(",")) if env else _CHAIN_CHANNELS
    if set(chans) - {64}:
        raise NotImplementedError(
            f"DGMSR_CHAIN_C={env}: the port's chain kernels take C=64 only "
            "(the C>=128 unpacked mode is not ported)"
        )
    return chans


def chain_eligible(h: int, w: int, c: int) -> bool:
    """ResnetBlock pairs of width ``c`` go to the chain kernels
    (``DGMSR_PALLAS_FUSED``, default on)."""
    return _switch("DGMSR_PALLAS_FUSED", "1") and c in chain_channels() and h >= 2 and w >= 2


def chain_stem_enabled() -> bool:
    """Down stage 0's stem conv and 1x1 residual run inside the chain
    (``DGMSR_PALLAS_STEM``, default on)."""
    return _switch("DGMSR_PALLAS_STEM", "1")


def chain_ds_enabled() -> bool:
    """Down stage 0's Downsample folds into the stem chain
    (``DGMSR_PALLAS_DS``, default off)."""
    return _switch("DGMSR_PALLAS_DS", "0")


def chain_head_enabled(c_stream: int, dim_out: int) -> bool:
    """The up stage's head conv over ``[x || skip]`` and its 1x1 residual
    run inside the chain (``DGMSR_PALLAS_HEAD``, default off)."""
    return _switch("DGMSR_PALLAS_HEAD", "0") and dim_out == 64 and c_stream % 64 == 0 and c_stream <= 128


def tail_eligible(h: int, w: int, c: int) -> bool:
    """The last Upsample, final Block and final 1x1 go to the tail kernel
    (``DGMSR_PALLAS_TAIL``, default on); ``h``/``w``/``c`` are the
    pre-upsample dims."""
    return _switch("DGMSR_PALLAS_TAIL", "1") and c == 64 and h >= 2 and w >= 2


def rowpack_eligible(x: torch.Tensor, c_in: int, features: int) -> bool:
    """A C -> C reflect conv of a Block (no skip join) goes to the conv3x3
    kernel (``DGMSR_PALLAS_CONV``, default off), C in {32, 64}."""
    return (_switch("DGMSR_PALLAS_CONV", "0") and c_in == features and features in (32, 64)
            and x.ndim == 4 and x.shape[2] >= 2 and x.shape[3] >= 2)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)); softplus is x itself above 20. One kernel,
    computed in float32 for a bf16 input and rounded once."""
    return F.mish(x)


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Timestep embedding with log(10000)/(half-1) spacing: (N,) -> (N, dim)
    float32."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000.0) / (half - 1))
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad(1) of an NCHW-shaped tensor, written channels_last on
    the card (CUDA's ``F.pad(mode="reflect")`` writes NCHW, and cuDNN then
    transposes around every conv): the interior, then the top and bottom
    rows, then the left and right columns, corners included."""
    b, c, h, w = x.shape
    fmt = torch.channels_last if x.is_cuda else torch.contiguous_format
    out = torch.empty((b, c, h + 2, w + 2), dtype=x.dtype, device=x.device, memory_format=fmt)
    out[:, :, 1:-1, 1:-1] = x
    out[:, :, 0, 1:-1] = x[:, :, 1]
    out[:, :, -1, 1:-1] = x[:, :, -2]
    out[:, :, :, 0] = out[:, :, :, 2]
    out[:, :, :, -1] = out[:, :, :, -3]
    return out


def reflect_conv3x3(x, weight, bias=None, stride: int = 1):
    """ReflectionPad(1) + 3x3 conv in the dtype of ``x``."""
    dt = x.dtype
    return F.conv2d(
        reflect_pad1(x), weight.to(dt), None if bias is None else bias.to(dt), stride=stride,
    )


def conv(x, layer: nn.Conv2d | nn.ConvTranspose2d):
    """Apply a conv layer's params in the dtype of ``x``."""
    dt = x.dtype
    w, b = layer.weight.to(dt), None if layer.bias is None else layer.bias.to(dt)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, layer.stride, layer.padding, layer.output_padding)
    return F.conv2d(x, w, b, layer.stride, layer.padding)


def linear(x, layer: nn.Linear):
    dt = x.dtype
    return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))


class Block(nn.Module):
    """ReflectionPad(1) -> Conv3x3 -> Mish (``groups=0``, the SRDiff config).

    ``joined``: ``x`` is the up stages' ``[x || skip]`` join, which the JAX
    package convolves as two inputs and never sends to the conv3x3 kernel."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.block = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(dim_in, dim_out, 3), Mish())

    def _conv(self, x, act: bool, joined: bool):
        c = self.block[1]
        if not joined and rowpack_eligible(x, c.in_channels, c.out_channels):
            from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k

            return k.conv3x3(x, c.weight, c.bias, border="reflect", mish=act)
        y = reflect_conv3x3(x, c.weight, c.bias)
        return mish(y) if act else y

    def pre_act(self, x, joined: bool = False):
        """The conv with its bias, before Mish."""
        return self._conv(x, False, joined)

    def forward(self, x, joined: bool = False):
        return self._conv(x, True, joined)


class ResnetBlock(nn.Module):
    """2 x Block + time-embedding add + optional cond add + 1x1 residual.

    ``skip``: the up stages' skip tensor, joined after ``x`` on the channel
    axis (``[x || skip]``) as the input of block1 and of the residual conv."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim_in, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else nn.Identity()

    def time_vec(self, time_emb):
        """(B, dim_out) = Linear(mish(time_emb)), in the dtype of time_emb."""
        return linear(mish(time_emb), self.mlp[1])

    def residual(self, x):
        return x if isinstance(self.res_conv, nn.Identity) else conv(x, self.res_conv)

    def forward(self, x, time_emb, cond=None, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        h = self.block1(x, joined=skip is not None) + self.time_vec(time_emb)[:, :, None, None]
        if cond is not None:
            h = h + cond
        return self.block2(h) + self.residual(x)


class Upsample(nn.Module):
    """ConvTranspose(k=4, s=2, p=1): doubles H and W."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Sequential(nn.ConvTranspose2d(dim, dim, 4, 2, 1))

    def forward(self, x):
        return conv(x, self.conv[0])


class Downsample(nn.Module):
    """ReflectionPad(1) + Conv3x3 stride 2: halves H and W."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, 2))

    def forward(self, x):
        c = self.conv[1]
        return reflect_conv3x3(x, c.weight, c.bias, stride=2)
