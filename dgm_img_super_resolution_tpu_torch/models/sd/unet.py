"""Text-conditioned UNet of the SD x4-upscaler (counterpart of the JAX
package's ``models/sd/unet.py``), under the published diffusers
``UNet2DConditionModel`` names and in NCHW.

The 4-channel latent is concatenated with the noise-augmented 3-channel LR
image (``in_channels`` 7); down and up blocks are GroupNorm + SiLU ResBlocks
with ``Transformer2D`` cross-attention to the text states; the LR noise level
is a learned class embedding (``num_class_embeds``) added to the time
embedding; without ``num_class_embeds`` the class labels go through the
timestep-style embedding instead (sinusoidal + Linear + SiLU + Linear,
``class_embedding.linear_1/2``, diffusers ``class_embed_type="timestep"``,
JAX ``:159-171``). ``attention_head_dim`` in the published config is the head
COUNT (8). ``mode`` splits the forward at the bottleneck for encoder
propagation, as the SRDiff UNet: ``"encode"`` returns ``(skips, h)`` after
the down path; ``"decode"`` takes them as ``enc_feats`` and runs the mid
block, the up path and the output convs.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.sd.attention import Transformer2D, gn_groups

NORM_EPS = 1e-5  # diffusers UNet norm_eps (the VAE and Transformer2D use 1e-6)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with ``flip_sin_to_cos=True`` and
    ``downscale_freq_shift=0``: frequencies exp(-ln(1e4) i / half), [cos, sin].
    Not SRDiff's convention (``half - 1`` spacing, [sin, cos])."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv3x3 -> + time projection -> GN -> SiLU -> conv3x3,
    plus the input (through a 1x1 ``conv_shortcut`` when the width changes).
    The JAX package's ``SDResBlock``."""

    def __init__(self, cin: int, cout: int, tdim: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(gn_groups(cin), cin, eps=NORM_EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(tdim, cout)
        self.norm2 = nn.GroupNorm(gn_groups(cout), cout, eps=NORM_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Conv(nn.Module):
    """``<block>.{down,up}samplers.0``: a module holding ``conv``."""

    def __init__(self, ch: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=1)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, tdim, layers, heads, cross_dim, attn, only_cross, add_down):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout, tdim) for j in range(layers)])
        self.attentions = nn.ModuleList(
            [Transformer2D(cout, heads, cross_dim, only_cross) for _ in range(layers)]
        ) if attn else None
        self.downsamplers = nn.ModuleList([Conv(cout, stride=2)]) if add_down else None

    def forward(self, h, temb, ctx, skips):
        for j, res in enumerate(self.resnets):
            h = res(h, temb)
            if self.attentions is not None:
                h = self.attentions[j](h, ctx)
            skips.append(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0].conv(h)
            skips.append(h)
        return h


class UpBlock(nn.Module):
    def __init__(self, prev, cin, cout, tdim, layers, heads, cross_dim, attn, only_cross, add_up):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev if j == 0 else cout) + (cin if j == layers else cout), cout, tdim)
            for j in range(layers + 1)
        ])
        self.attentions = nn.ModuleList(
            [Transformer2D(cout, heads, cross_dim, only_cross) for _ in range(layers + 1)]
        ) if attn else None
        self.upsamplers = nn.ModuleList([Conv(cout)]) if add_up else None

    def forward(self, h, temb, ctx, skips):
        for j, res in enumerate(self.resnets):
            h = res(torch.cat([h, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                h = self.attentions[j](h, ctx)
        if self.upsamplers is not None:
            h = self.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return h


class MidBlock(nn.Module):
    def __init__(self, ch, tdim, heads, cross_dim):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, tdim), ResnetBlock2D(ch, ch, tdim)])
        self.attentions = nn.ModuleList([Transformer2D(ch, heads, cross_dim)])

    def forward(self, h, temb, ctx):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, ctx)
        return self.resnets[1](h, temb)


class TimestepMLP(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DCondition(nn.Module):
    """Built from a diffusers ``UNet2DConditionModel`` config dict
    (``ckpt/sd_inventory.X4_UNET_CONFIG``), as the JAX ``from_config``."""

    def __init__(self, cfg: dict):
        super().__init__()
        chs = list(cfg["block_out_channels"])
        lpb = cfg["layers_per_block"]
        cross = cfg["cross_attention_dim"]
        heads = cfg["attention_head_dim"]  # SD-era semantics: the head count
        tdim = chs[0] * 4
        down_attn = ["CrossAttn" in t for t in cfg["down_block_types"]]
        up_attn = ["CrossAttn" in t for t in cfg["up_block_types"]]
        oc = list(cfg.get("only_cross_attention") or [False] * len(chs))
        self.ch0 = chs[0]

        self.conv_in = nn.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = TimestepMLP(chs[0], tdim)
        n_class = cfg.get("num_class_embeds")
        # a learned table (the published model), else the timestep-style MLP
        self.class_embedding = nn.Embedding(n_class, tdim) if n_class else TimestepMLP(chs[0], tdim)
        cin, blocks = chs[0], []
        for i, ch in enumerate(chs):
            blocks.append(DownBlock(cin, ch, tdim, lpb, heads, cross, down_attn[i], oc[i],
                                    i < len(chs) - 1))
            cin = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(chs[-1], tdim, heads, cross)
        rev, prev, blocks = chs[::-1], chs[-1], []
        for i, out_ch in enumerate(rev):
            level = len(chs) - 1 - i
            blocks.append(UpBlock(prev, rev[min(i + 1, len(chs) - 1)], out_ch, tdim, lpb, heads, cross,
                                  up_attn[i], oc[level], i < len(chs) - 1))
            prev = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(gn_groups(chs[0]), chs[0], eps=NORM_EPS)
        self.conv_out = nn.Conv2d(chs[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, timesteps, encoder_hidden_states, class_labels=None, *, mode: str = "full",
                enc_feats=None):
        """x: (N, in_ch, H, W) latent and LR image; timesteps: (N,);
        encoder_hidden_states: (N, L, cross_dim); class_labels: (N,) LR noise
        level -> (N, out_ch, H, W); with ``mode="encode"`` the down path's
        ``(skips, h)``, which ``mode="decode"`` takes as ``enc_feats`` (``x``
        unused)."""
        if mode not in ("full", "encode", "decode"):
            raise ValueError(f"mode {mode!r}")
        dt = self.conv_in.weight.dtype
        temb = self.time_embedding(timestep_embedding(timesteps, self.ch0).to(dt))
        if class_labels is not None:
            if isinstance(self.class_embedding, nn.Embedding):
                temb = temb + self.class_embedding(class_labels)
            else:
                temb = temb + self.class_embedding(timestep_embedding(class_labels, self.ch0).to(dt))
        if mode == "decode":
            skips, h = list(enc_feats[0]), enc_feats[1]
        else:
            h = self.conv_in(x)
            skips = [h]
            for blk in self.down_blocks:
                h = blk(h, temb, encoder_hidden_states, skips)
            if mode == "encode":
                return tuple(skips), h
        h = self.mid_block(h, temb, encoder_hidden_states)
        for blk in self.up_blocks:
            h = blk(h, temb, encoder_hidden_states, skips)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
