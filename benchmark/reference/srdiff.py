"""Plain reference of the SRDiff x4 serve: float32 PyTorch, no kernels, no
graphs, no batching tricks.

It follows SRDiff (Li et al., arXiv:2104.14951) and the reference
implementation's ``srdiff/config.yaml`` as the configuration file states
them: an RRDB encoder run once (``get_fea``: the trunk's features 2, 5 and 8
concatenated), its features projected to HR by a ConvTranspose, a
conditional UNet (reflect-padded 3x3 Blocks with Mish, ResnetBlocks with a
time-embedding add, the condition added after down stage 0, stride-2
Downsamples, ConvTranspose Upsamples, ``[x || skip]`` joins), the cosine
schedule of T steps, DDIM over ``steps`` strided timesteps with ``eta``
(x0 clipped), the residual back to the image over the bicubic x4 of the LR
input, and the uint8 rounding. Parameter names are the reference
checkpoint's (``denoise_fn.*``, ``rrdb.*``), so one state dict serves the
program and this file. Every conv and product goes through
``precision.py``, so the control runs the same code in a lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import precision as P


def mish(x):
    return x * torch.tanh(F.softplus(x))


def lrelu(x):
    return F.leaky_relu(x, 0.2)


# ---------------------------------------------------------------- RRDB
class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.conv1 = P.Conv2d(nf, gc, 3, 1, 1)
        self.conv2 = P.Conv2d(nf + gc, gc, 3, 1, 1)
        self.conv3 = P.Conv2d(nf + 2 * gc, gc, 3, 1, 1)
        self.conv4 = P.Conv2d(nf + 3 * gc, gc, 3, 1, 1)
        self.conv5 = P.Conv2d(nf + 4 * gc, nf, 3, 1, 1)

    def forward(self, x):
        x1 = lrelu(self.conv1(x))
        x2 = lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        return self.conv5(torch.cat([x, x1, x2, x3, x4], 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.RDB1, self.RDB2, self.RDB3 = (ResidualDenseBlock5C(nf, gc) for _ in range(3))

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """Input and output in [-1, 1]; the trunk's per-block features and the
    fused trunk feature are returned beside the output."""

    def __init__(self, nf: int, nb: int, gc: int):
        super().__init__()
        self.conv_first = P.Conv2d(3, nf, 3, 1, 1)
        self.RRDB_trunk = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = P.Conv2d(nf, nf, 3, 1, 1)
        self.upconv1 = P.Conv2d(nf, nf, 3, 1, 1)
        self.upconv2 = P.Conv2d(nf, nf, 3, 1, 1)
        self.HRconv = P.Conv2d(nf, nf, 3, 1, 1)
        self.conv_last = P.Conv2d(nf, 3, 3, 1, 1)

    def features(self, x):
        feas = []
        fea = first = self.conv_first((x + 1.0) / 2.0)
        for blk in self.RRDB_trunk:
            fea = blk(fea)
            feas.append(fea)
        feas.append(first + self.trunk_conv(fea))
        return feas


# ---------------------------------------------------------------- UNet
class Block(nn.Module):
    """Reflect pad 1, 3x3 conv, Mish."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(nn.ReflectionPad2d(1), P.Conv2d(cin, cout, 3), nn.Mish())

    def forward(self, x):
        return mish(self.block[1](F.pad(x, (1, 1, 1, 1), mode="reflect")))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(), P.Linear(tdim, cout))
        self.block1 = Block(cin, cout)
        self.block2 = Block(cout, cout)
        self.res_conv = P.Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, temb):
        h = self.block1(x) + self.mlp[1](mish(temb))[:, :, None, None]
        return self.block2(h) + self.res_conv(x)


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Sequential(nn.ReflectionPad2d(1), P.Conv2d(dim, dim, 3, 2))

    def forward(self, x):
        return self.conv[1](F.pad(x, (1, 1, 1, 1), mode="reflect"))


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Sequential(P.ConvTranspose2d(dim, dim, 4, 2, 1))

    def forward(self, x):
        return self.conv[0](x)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, log(10000) / (half - 1) spacing, [sin, cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Unet(nn.Module):
    def __init__(self, dim: int, dim_mults: tuple[int, ...], cond_ch: int, sr_scale: int):
        super().__init__()
        self.dim = dim
        dims = [3] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.cond_proj = P.ConvTranspose2d(cond_ch, dim, sr_scale * 2, sr_scale, sr_scale // 2)
        self.mlp = nn.Sequential(P.Linear(dim, dim * 4), nn.Mish(), P.Linear(dim * 4, dim))
        self.downs = nn.ModuleList()
        for i, (di, do) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([ResnetBlock(di, do, dim), ResnetBlock(do, do, dim),
                                             Downsample(do) if not last else nn.Identity()]))
        self.mid_block1 = ResnetBlock(dims[-1], dims[-1], dim)
        self.mid_block2 = ResnetBlock(dims[-1], dims[-1], dim)
        self.ups = nn.ModuleList()
        for di, do in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([ResnetBlock(do * 2, di, dim), ResnetBlock(di, di, dim), Upsample(di)]))
        self.final_conv = nn.Sequential(Block(dim, dim), P.Conv2d(dim, 3, 1))

    def forward(self, x, t, cond_proj):
        temb = self.mlp[2](mish(self.mlp[0](time_embedding(t, self.dim))))
        skips = []
        for i, (rb1, rb2, down) in enumerate(self.downs):
            x = rb2(rb1(x, temb), temb)
            if i == 0:
                x = x + cond_proj
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_block1(x, temb), temb)
        for rb1, rb2, up in self.ups:
            x = up(rb2(rb1(torch.cat([x, skips.pop()], 1), temb), temb))
        return self.final_conv[1](self.final_conv[0](x))


class SRDiff(nn.Module):
    """``denoise_fn`` and ``rrdb`` under the checkpoint's names."""

    def __init__(self, cfg: dict):
        super().__init__()
        nf, nb = cfg["rrdb_num_feat"], cfg["rrdb_num_block"]
        mults = tuple(int(m) for m in str(cfg["unet_dim_mults"]).split("|"))
        n_sel = len(range(2, nb + 1, 3))
        self.denoise_fn = Unet(cfg["hidden_size"], mults, nf * n_sel, cfg["sr_scale"])
        self.rrdb = RRDBNet(nf, nb, nf // 2)
        self.cfg = cfg


# ------------------------------------------------------------- sampler
def cosine_alphas_cumprod(timesteps: int, s: float) -> np.ndarray:
    """The cosine schedule's alphas_cumprod, in float64, clipped as the
    betas are (at 0.999)."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    f = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    f = f / f[0]
    betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    return np.cumprod(1.0 - betas)


def ddim_timesteps(T: int, steps: int) -> list[int]:
    return [int(v) for v in np.linspace(0, T - 1, steps, dtype=np.float32).round().astype(np.int64)[::-1]]


def noise_timesteps(cfg: dict) -> list[int]:
    """The timesteps whose DDIM update draws noise (sigma > 0)."""
    acp = cosine_alphas_cumprod(cfg["timesteps"], cfg["beta_s"]).astype(np.float32)
    ts = ddim_timesteps(cfg["timesteps"], cfg["steps"])
    out = []
    for ti, tp in zip(ts, ts[1:] + [-1]):
        a_t, a_prev = acp[ti], (acp[tp] if tp >= 0 else np.float32(1.0))
        sigma = np.float32(cfg["eta"]) * np.sqrt((1 - a_prev) / (1 - a_t)) * np.sqrt(1 - a_t / a_prev)
        if sigma > 0:
            out.append(ti)
    return out


def bicubic(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bicubic x``scale`` as ``F.interpolate`` takes it: a = -0.75, corners
    aligned, edges clamped."""
    return F.interpolate(x, scale_factor=scale, mode="bicubic", align_corners=True)


@torch.no_grad()
def serve(model: SRDiff, lr_u8: torch.Tensor, x_t: torch.Tensor, step_noise: dict[int, torch.Tensor]):
    """NHWC uint8 LR batch (its H and W x scale divisible by
    2^(stages - 1): no pad), the initial state and each noisy step's noise
    (NCHW at HR) -> the SR batch, NHWC float in [0, 1] before rounding."""
    cfg = model.cfg
    scale = cfg["sr_scale"]
    x = lr_u8.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    up = bicubic(x, scale)
    feas = model.rrdb.features(x)
    unet = model.denoise_fn
    cond = unet.cond_proj(torch.cat(feas[2::3], 1))
    acp = cosine_alphas_cumprod(cfg["timesteps"], cfg["beta_s"]).astype(np.float32)
    ts = ddim_timesteps(cfg["timesteps"], cfg["steps"])
    f, eta = np.float32, np.float32(cfg["eta"])
    xt = x_t.float()
    for ti, tp in zip(ts, ts[1:] + [-1]):
        eps = unet(xt, torch.full((xt.shape[0],), ti, dtype=torch.long, device=xt.device), cond)
        a_t = acp[ti]
        a_prev = acp[tp] if tp >= 0 else f(1.0)
        x0 = ((xt - float(np.sqrt(f(1.0) - a_t)) * eps) / float(np.sqrt(a_t))).clamp(-1.0, 1.0)
        eps = (xt - float(np.sqrt(a_t)) * x0) / float(np.sqrt(f(1.0) - a_t))
        sigma = eta * np.sqrt((f(1.0) - a_prev) / (f(1.0) - a_t)) * np.sqrt(f(1.0) - a_t / a_prev)
        c_dir = np.sqrt(np.maximum(f(1.0) - a_prev - sigma * sigma, f(0.0)))
        xt = float(np.sqrt(a_prev)) * x0 + float(c_dir) * eps
        if sigma > 0:
            xt = xt + float(sigma) * step_noise[ti].float()
    img = xt.clamp(-1.0, 1.0) / cfg["res_rescale"] + up
    return (img * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round(img * 255.0).to(torch.uint8)
