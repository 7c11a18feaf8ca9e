"""RRDB low-resolution encoder (counterpart of the JAX package's
``models/rrdb.py``): dense residual blocks with LeakyReLU(0.2) and 0.2
residual scaling, an ``nb``-block trunk with a global skip, and a x4 (or x8)
nearest-upsample head. ``forward(x, get_fea=True)`` also returns the
per-block features and the fused trunk feature that condition the UNet.
It runs once per request, outside the sampler loop; its convs are plain
zero-padded 3x3 convs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import conv
from dgm_img_super_resolution_tpu_torch.ops.resize import nearest_upsample


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.conv1 = _conv3(nf, gc)
        self.conv2 = _conv3(nf + gc, gc)
        self.conv3 = _conv3(nf + 2 * gc, gc)
        self.conv4 = _conv3(nf + 3 * gc, gc)
        self.conv5 = _conv3(nf + 4 * gc, nf)

    def forward(self, x):
        x1 = _lrelu(conv(x, self.conv1))
        x2 = _lrelu(conv(torch.cat([x, x1], 1), self.conv2))
        x3 = _lrelu(conv(torch.cat([x, x1, x2], 1), self.conv3))
        x4 = _lrelu(conv(torch.cat([x, x1, x2, x3], 1), self.conv4))
        x5 = conv(torch.cat([x, x1, x2, x3, x4], 1), self.conv5)
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc)
        self.RDB2 = ResidualDenseBlock5C(nf, gc)
        self.RDB3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """``RRDBNet(out_nc=3, nf=32, nb=8, gc=16, sr_scale=4)`` in the SRDiff
    config. Input and output in [-1, 1]: the input is mapped to [0, 1]
    inside and the output clamped and mapped back. Activations run in
    ``dtype``."""

    def __init__(self, out_nc: int = 3, nf: int = 32, nb: int = 8, gc: int = 32, sr_scale: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sr_scale = sr_scale
        self.dtype = dtype
        self.conv_first = _conv3(3, nf)
        self.RRDB_trunk = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = _conv3(nf, nf)
        self.upconv1 = _conv3(nf, nf)
        self.upconv2 = _conv3(nf, nf)
        if sr_scale == 8:
            self.upconv3 = _conv3(nf, nf)
        self.HRconv = _conv3(nf, nf)
        self.conv_last = _conv3(nf, out_nc)

    def forward(self, x, get_fea: bool = False):
        feas = []
        x = ((x + 1.0) / 2.0).to(self.dtype)
        fea_first = fea = conv(x, self.conv_first)
        for blk in self.RRDB_trunk:
            fea = blk(fea)
            feas.append(fea)
        fea = fea_first + conv(fea, self.trunk_conv)
        feas.append(fea)
        fea = _lrelu(conv(nearest_upsample(fea, 2), self.upconv1))
        fea = _lrelu(conv(nearest_upsample(fea, 2), self.upconv2))
        if self.sr_scale == 8:
            fea = _lrelu(conv(nearest_upsample(fea, 2), self.upconv3))
        out = conv(_lrelu(conv(fea, self.HRconv)), self.conv_last)
        out = out.clamp(0.0, 1.0) * 2.0 - 1.0
        if get_fea:
            return out, feas
        return out
