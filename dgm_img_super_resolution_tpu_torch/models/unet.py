"""SRDiff conditional noise-prediction UNet (counterpart of the JAX package's
``models/unet.py``), NCHW with the reference checkpoint's module names.

- dims ladder ``[3, dim*m for m in dim_mults]`` (dim 64, mults 1|2|3|4);
- down stages of 2 x ResnetBlock + Downsample (none after the last); the
  RRDB condition, projected to HR by a ConvTranspose(2s, s, s/2), and the
  optional LR-upsample projection are added after down stage 0;
- mid block1 / block2;
- up stages with the ``[x || skip]`` join; only 3 of the 4 saved skips are
  popped (the reference topology);
- final reflect Block + 1x1 conv.

Regions go to the kernel wrappers of ``ops/kernels`` through the gates of
``models/layers.py``, exactly where the JAX package's ``unet.py:141-372``
sends them to its Pallas kernels: a ResnetBlock pair of a width in the chain
set (C = 64) to ``block_chain3``, or, for down stage 0, to
``block_chain3_stem`` (with the Downsample folded in, ``block_chain3_stem_ds``,
when DS is on), or, for an up stage whose ``x`` and ``skip`` match, to
``block_chain3_head`` when HEAD is on; the last Upsample, final Block and
final 1x1 at C = 64 to ``tail_fuse``; and, when CONV is on, each C -> C
Block conv at C in {32, 64} to ``conv3x3``. Everything else, and every
region whose gate is off, takes the plain module path (cuDNN on the card).
On CPU tensors the wrappers run their plain versions, so the CPU tests go
through the same routing as the card. ``LinearAttention``, GroupNorm and the
encoder-propagation modes wait.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.models import layers as L
from dgm_img_super_resolution_tpu_torch.models.layers import (
    Block,
    Downsample,
    Mish,
    ResnetBlock,
    Upsample,
    conv,
    linear,
    mish,
    reflect_conv3x3,
    sinusoidal_pos_emb,
)
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
from dgm_img_super_resolution_tpu_torch.ops.kernels.tail_fuse import tail_fuse


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """On the card, activations are held channels_last (NHWC memory), the
    layout the kernels take; a no-op when they already are."""
    return t.contiguous(memory_format=torch.channels_last) if t.is_cuda else t


def _wb(c: nn.Module):
    """(weight, bias) of a conv layer."""
    return c.weight, c.bias


class Unet(nn.Module):
    def __init__(self, dim: int = 64, out_dim: int = 3, dim_mults=(1, 2, 3, 4), cond_dim: int = 32,
                 rrdb_num_block: int = 8, sr_scale: int = 4, use_attn: bool = False, res: bool = True,
                 up_input: bool = False, groups: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_attn or groups:
            raise NotImplementedError("use_attn and gn_groups are not ported yet")
        if len(dim_mults) < 2:
            raise NotImplementedError("the port's UNet needs at least two stages")
        self.dim, self.res, self.up_input, self.dtype = dim, res, up_input, dtype
        dims = [3] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_sel = len(range(2, rrdb_num_block + 1, 3))  # feas[2::3] of nb + 1 features
        self.cond_proj = nn.ConvTranspose2d(cond_dim * n_sel, dim, sr_scale * 2, sr_scale, sr_scale // 2)
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim))
        self.downs = nn.ModuleList()
        for i, (di, do) in enumerate(in_out):
            last = i >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(di, do, dim), ResnetBlock(do, do, dim),
                Downsample(do) if not last else nn.Identity(),
            ]))
        self.mid_block1 = ResnetBlock(dims[-1], dims[-1], dim)
        self.mid_block2 = ResnetBlock(dims[-1], dims[-1], dim)
        self.ups = nn.ModuleList()
        for di, do in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResnetBlock(do * 2, di, dim), ResnetBlock(di, di, dim), Upsample(di),
            ]))
        self.final_conv = nn.Sequential(Block(dim, dim), nn.Conv2d(dim, out_dim, 1))
        if res and up_input:
            self.up_proj = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(3, dim, 3))

    def project(self, cond, img_lr_up=None):
        """The HR-projected condition, hoisted out of the sampler loop: it
        depends on neither x nor t. With ``img_lr_up`` (res + up_input) the
        up-projection is folded in too; per-step calls then pass
        ``up_folded=True``."""
        cond_proj = conv(cond.to(self.dtype), self.cond_proj)
        if self.res and self.up_input and img_lr_up is not None:
            cond_proj = cond_proj + self._up_proj(img_lr_up)
        return cond_proj

    def _up_proj(self, img_lr_up):
        c = self.up_proj[1]
        return reflect_conv3x3(img_lr_up.to(self.dtype), c.weight, c.bias)

    def forward(self, x, time, cond, img_lr_up=None, *, cond_projected: bool = False,
                up_folded: bool = False):
        """x: (N,3,H,W) noisy residual; time: (N,) int; cond: the channel
        concat of the selected RRDB features at LR (or its projection, with
        ``cond_projected=True``); img_lr_up: (N,3,H,W). Returns eps (N,3,H,W)
        in the compute dtype."""
        dt = self.dtype
        cond_proj = _nhwc(cond.to(dt) if cond_projected else self.project(cond))
        t = sinusoidal_pos_emb(time, self.dim).to(dt)
        t = linear(mish(linear(t, self.mlp[0])), self.mlp[2])
        x = _nhwc(x.to(dt))

        h = []
        for i, (rb1, rb2, down) in enumerate(self.downs):
            last = i == len(self.downs) - 1
            dim_out = rb1.block1.block[1].out_channels
            x_ds = None
            if L.chain_eligible(x.shape[2], x.shape[3], dim_out):
                fold_ds = (
                    i == 0 and not last and x.shape[1] <= 4 and L.chain_ds_enabled()
                    and L.chain_stem_enabled() and dim_out == 64
                    and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
                    and not (self.res and self.up_input and not up_folded)
                )
                out = self._fused_pair(rb1, rb2, x, t, cond=cond_proj if i == 0 else None,
                                       ds=down if fold_ds else None)
                x, x_ds = out if isinstance(out, tuple) else (out, None)
            else:
                x = rb2(rb1(x, t), t)
                if i == 0:
                    x = x + cond_proj
            if i == 0 and self.res and self.up_input and not up_folded:
                if img_lr_up is None:
                    raise ValueError(
                        "Unet: res+up_input needs img_lr_up per step, or a projection "
                        "that folded it in (then pass up_folded=True)"
                    )
                x = x + self._up_proj(img_lr_up)
            h.append(x)
            if not last:
                x = x_ds if x_ds is not None else down(x)

        if L.chain_eligible(x.shape[2], x.shape[3], x.shape[1]):
            x = self._fused_pair(self.mid_block1, self.mid_block2, x, t)
        else:
            x = self.mid_block2(self.mid_block1(x, t), t)

        for i, (rb1, rb2, up) in enumerate(self.ups):
            dim_in = rb2.block1.block[1].out_channels
            if L.chain_eligible(x.shape[2], x.shape[3], dim_in):
                x = self._fused_pair(rb1, rb2, x, t, skip=h.pop())
            else:
                x = rb2(rb1(x, t, skip=h.pop()), t)
            if i == len(self.ups) - 1 and L.tail_eligible(x.shape[2], x.shape[3], dim_in):
                return tail_fuse(x, *_wb(up.conv[0]), *_wb(self.final_conv[0].block[1]),
                                 *_wb(self.final_conv[1]))
            x = _nhwc(up(x))
        return conv(self.final_conv[0](x), self.final_conv[1])

    @staticmethod
    def _fused_pair(rb1, rb2, x, t, skip=None, cond=None, ds=None):
        """A ResnetBlock pair through the chain kernels (JAX ``unet.py``
        ``fused_pair``); returns ``(out, ds_out)`` when ``ds`` (down stage
        0's Downsample) folds in."""
        dim_out = rb1.block1.block[1].out_channels
        tv1, tv2 = rb1.time_vec(t), rb2.time_vec(t)
        tail = (*_wb(rb1.block2.block[1]), *_wb(rb2.block1.block[1]), *_wb(rb2.block2.block[1]))
        if skip is not None and x.shape == skip.shape and L.chain_head_enabled(x.shape[1], dim_out):
            return bc.block_chain3_head(_nhwc(x), _nhwc(skip), *_wb(rb1.block1.block[1]),
                                        *_wb(rb1.res_conv), tv1, tv2, *tail)
        if x.shape[1] <= 4 and skip is None and L.chain_stem_enabled() and dim_out == 64:
            head = (x, *_wb(rb1.block1.block[1]), *_wb(rb1.res_conv), tv1, tv2, *tail, cond)
            if ds is not None:
                return bc.block_chain3_stem_ds(*head, *_wb(ds.conv[1]))
            return bc.block_chain3_stem(*head)
        joined = skip is not None
        xs = torch.cat([x, skip], dim=1) if joined else x
        a_pre, r1 = rb1.block1.pre_act(xs, joined=joined), rb1.residual(xs)
        return bc.block_chain3(_nhwc(a_pre), _nhwc(r1), tv1, tv2, *tail, cond)

