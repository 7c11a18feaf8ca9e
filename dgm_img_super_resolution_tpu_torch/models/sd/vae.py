"""AutoencoderKL, the SD x4-upscaler's f=4 VAE (counterpart of the JAX
package's ``models/sd/vae.py``), under the published diffusers names with the
legacy mid-block attention keys (``group_norm``, ``query``, ``key``,
``value``, ``proj_attn``) and in NCHW. GroupNorm eps is 1e-6 throughout.

Serving runs ``decode`` only; the encoder is here so that the published
state dict loads whole. The mid-block attention is plain single-head
attention, as in the JAX package; at a 256x256 latent it spans 65,536
tokens, so it runs in query chunks that bound the score matrix's memory
without changing the maths.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.sd.attention import gn_groups

EPS = 1e-6
ATTN_SCORE_ELEMS = 1 << 27  # score elements per query chunk of the mid attention


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(gn_groups(cin), cin, eps=EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(gn_groups(cout), cout, eps=EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over the pixels: scores in the input dtype
    scaled by C^-1/2, softmax in float32, probabilities cast back."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(gn_groups(ch), ch, eps=EPS)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.query(y), self.key(y), self.value(y)
        kt = k.transpose(1, 2)
        chunk = max(1, ATTN_SCORE_ELEMS // (b * h * w))
        out = torch.empty_like(q)
        for i in range(0, h * w, chunk):
            scores = torch.matmul(q[:, i:i + chunk], kt) * c**-0.5
            probs = torch.softmax(scores.float(), dim=-1).to(y.dtype)
            del scores
            out[:, i:i + chunk] = torch.matmul(probs, v)
        out = self.proj_attn(out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Sampler(nn.Module):
    """``<block>.{down,up}samplers.0``: a module holding ``conv``."""

    def __init__(self, ch: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding)


class VAEMid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch), VAEResnet(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class VAEDown(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, add_down: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(cin if j == 0 else cout, cout) for j in range(layers)])
        self.downsamplers = nn.ModuleList([Sampler(cout, 2, 0)]) if add_down else None

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if self.downsamplers is not None:
            # diffusers Downsample2D with padding 0: pad one row/col after only
            h = self.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        return h


class VAEUp(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, add_up: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(cin if j == 0 else cout, cout) for j in range(layers + 1)])
        self.upsamplers = nn.ModuleList([Sampler(cout, 1, 1)]) if add_up else None

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if self.upsamplers is not None:
            h = self.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chs = list(cfg["block_out_channels"])
        lpb = cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [VAEDown(chs[max(i - 1, 0)], ch, lpb, i < len(chs) - 1) for i, ch in enumerate(chs)]
        )
        self.mid_block = VAEMid(chs[-1])
        self.conv_norm_out = nn.GroupNorm(gn_groups(chs[-1]), chs[-1], eps=EPS)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        rev = list(cfg["block_out_channels"])[::-1]  # deepest first
        lpb = cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0])
        self.up_blocks = nn.ModuleList(
            [VAEUp(rev[max(i - 1, 0)], ch, lpb, i < len(rev) - 1) for i, ch in enumerate(rev)]
        )
        self.conv_norm_out = nn.GroupNorm(gn_groups(rev[-1]), rev[-1], eps=EPS)
        self.conv_out = nn.Conv2d(rev[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        lat = cfg["latent_channels"]
        self.latent_channels = lat
        self.scaling_factor = float(cfg["scaling_factor"])
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image in [-1, 1] -> scaled latents (the posterior mean)."""
        mean, _ = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean * self.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> image in [-1, 1] (not clipped)."""
        return self.decoder(self.post_quant_conv(z / self.scaling_factor))
