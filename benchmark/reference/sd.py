"""Plain reference of the Stable Diffusion x4-upscaler serve: float32
PyTorch, no kernels, no graphs.

The modules follow the published diffusers ``UNet2DConditionModel``
(``unet/config.json``), ``AutoencoderKL`` (``vae/config.json``, legacy
mid-attention names) and transformers ``CLIPTextModel``
(``text_encoder/config.json``) of ``stabilityai/stable-diffusion-x4-upscaler``,
under their published parameter names, so one state dict serves the program
and this file. The serve: the prompts' and the empty negative prompts' token
ids through the text encoder, the LR image noise-augmented on the low-res
DDPM schedule at ``noise_level``, DDIM (``eta``) over diffusers' "leading"
timesteps with v-prediction and classifier-free guidance as a doubled batch,
then the VAE decode. Every conv and product goes through ``precision.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import precision as P

UNET_NORM_EPS = 1e-5
VAE_EPS = 1e-6
ATTN_QUERY_ROWS = 1 << 27  # score elements a query chunk of the VAE's mid attention


def gn_groups(ch: int, preferred: int = 32) -> int:
    g = min(preferred, ch)
    while ch % g:
        g -= 1
    return g


def attention(q, k, v):
    """q (B, Lq, H, D), k and v (B, Lk, H, D): softmax(q k^T / sqrt(D)) v."""
    scores = P.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return P.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v)


# ---------------------------------------------------------------- UNet
def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' embedding, ``flip_sin_to_cos`` and shift 0: [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(gn_groups(cin), cin, eps=UNET_NORM_EPS)
        self.conv1 = P.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = P.Linear(tdim, cout)
        self.norm2 = nn.GroupNorm(gn_groups(cout), cout, eps=UNET_NORM_EPS)
        self.conv2 = P.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = P.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x))) + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_dim: int | None = None):
        super().__init__()
        kv_dim = dim if kv_dim is None else kv_dim
        self.heads = heads
        self.to_q = P.Linear(dim, dim, bias=False)
        self.to_k = P.Linear(kv_dim, dim, bias=False)
        self.to_v = P.Linear(kv_dim, dim, bias=False)
        self.to_out = nn.ModuleList([P.Linear(dim, dim), nn.Dropout(0.0)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, lq, c = x.shape
        lk, hd = context.shape[1], c // self.heads
        q = self.to_q(x).view(b, lq, self.heads, hd)
        k = self.to_k(context).view(b, lk, self.heads, hd)
        v = self.to_v(context).view(b, lk, self.heads, hd)
        return self.to_out[0](attention(q, k, v).reshape(b, lq, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = P.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0), P.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int, only_cross: bool):
        super().__init__()
        self.only_cross = only_cross
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, cross_dim if only_cross else None)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x), ctx if self.only_cross else None)
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, cross_dim: int, only_cross: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(gn_groups(ch), ch, eps=1e-6)
        self.proj_in = P.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, cross_dim, only_cross)])
        self.proj_out = P.Linear(ch, ch)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        return x + self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Conv(nn.Module):
    def __init__(self, ch: int, stride: int = 1):
        super().__init__()
        self.conv = P.Conv2d(ch, ch, 3, stride=stride, padding=1)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, tdim, layers, heads, cross_dim, attn, only_cross, add_down):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout, tdim) for j in range(layers)])
        self.attentions = nn.ModuleList(
            [Transformer2D(cout, heads, cross_dim, only_cross) for _ in range(layers)]) if attn else None
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
            for j in range(layers + 1)])
        self.attentions = nn.ModuleList(
            [Transformer2D(cout, heads, cross_dim, only_cross) for _ in range(layers + 1)]) if attn else None
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
        return self.resnets[1](self.attentions[0](self.resnets[0](h, temb), ctx), temb)


class TimestepMLP(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = P.Linear(cin, dim)
        self.linear_2 = P.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chs = list(cfg["block_out_channels"])
        lpb, cross, heads = cfg["layers_per_block"], cfg["cross_attention_dim"], cfg["attention_head_dim"]
        tdim = chs[0] * 4
        down_attn = ["CrossAttn" in t for t in cfg["down_block_types"]]
        up_attn = ["CrossAttn" in t for t in cfg["up_block_types"]]
        oc = list(cfg["only_cross_attention"])
        self.ch0 = chs[0]
        self.conv_in = P.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = TimestepMLP(chs[0], tdim)
        self.class_embedding = nn.Embedding(cfg["num_class_embeds"], tdim)
        cin, blocks = chs[0], []
        for i, ch in enumerate(chs):
            blocks.append(DownBlock(cin, ch, tdim, lpb, heads, cross, down_attn[i], oc[i], i < len(chs) - 1))
            cin = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(chs[-1], tdim, heads, cross)
        rev, prev, blocks = chs[::-1], chs[-1], []
        for i, out_ch in enumerate(rev):
            blocks.append(UpBlock(prev, rev[min(i + 1, len(chs) - 1)], out_ch, tdim, lpb, heads, cross,
                                  up_attn[i], oc[len(chs) - 1 - i], i < len(chs) - 1))
            prev = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(gn_groups(chs[0]), chs[0], eps=UNET_NORM_EPS)
        self.conv_out = P.Conv2d(chs[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx, class_labels):
        temb = self.time_embedding(timestep_embedding(t, self.ch0)) + self.class_embedding(class_labels)
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            h = blk(h, temb, ctx, skips)
        h = self.mid_block(h, temb, ctx)
        for blk in self.up_blocks:
            h = blk(h, temb, ctx, skips)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# ----------------------------------------------------------------- VAE
class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(gn_groups(cin), cin, eps=VAE_EPS)
        self.conv1 = P.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(gn_groups(cout), cout, eps=VAE_EPS)
        self.conv2 = P.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = P.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    """Single-head attention over the pixels, in query chunks that bound the
    score matrix's memory."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(gn_groups(ch), ch, eps=VAE_EPS)
        self.query, self.key, self.value, self.proj_attn = (P.Linear(ch, ch) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.query(y), self.key(y), self.value(y)
        kt = k.transpose(1, 2)
        rows = max(1, ATTN_QUERY_ROWS // (b * h * w))
        out = torch.cat([P.matmul((P.matmul(q[:, i:i + rows], kt) * c ** -0.5).softmax(dim=-1), v)
                         for i in range(0, h * w, rows)], dim=1)
        return x + self.proj_attn(out).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Sampler(nn.Module):
    def __init__(self, ch: int, stride: int, padding: int):
        super().__init__()
        self.conv = P.Conv2d(ch, ch, 3, stride=stride, padding=padding)


class VAEMid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch), VAEResnet(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class VAEDown(nn.Module):
    """The encoder's blocks: held so that the published state dict's names
    are whole; the serve never runs them."""

    def __init__(self, cin: int, cout: int, layers: int, add_down: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(cin if j == 0 else cout, cout) for j in range(layers)])
        self.downsamplers = nn.ModuleList([Sampler(cout, 2, 0)]) if add_down else None


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
        chs, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        self.conv_in = P.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [VAEDown(chs[max(i - 1, 0)], ch, lpb, i < len(chs) - 1) for i, ch in enumerate(chs)])
        self.mid_block = VAEMid(chs[-1])
        self.conv_norm_out = nn.GroupNorm(gn_groups(chs[-1]), chs[-1], eps=VAE_EPS)
        self.conv_out = P.Conv2d(chs[-1], 2 * cfg["latent_channels"], 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        rev, lpb = list(cfg["block_out_channels"])[::-1], cfg["layers_per_block"]
        self.conv_in = P.Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0])
        self.up_blocks = nn.ModuleList(
            [VAEUp(rev[max(i - 1, 0)], ch, lpb, i < len(rev) - 1) for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(gn_groups(rev[-1]), rev[-1], eps=VAE_EPS)
        self.conv_out = P.Conv2d(rev[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        lat = cfg["latent_channels"]
        self.scaling_factor = float(cfg["scaling_factor"])
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = P.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = P.Conv2d(lat, lat, 1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.scaling_factor))


# ---------------------------------------------------------------- CLIP
class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (P.Linear(d, d) for _ in range(4))

    def forward(self, x, mask):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = (p(x).view(b, n, self.heads, hd) for p in (self.q_proj, self.k_proj, self.v_proj))
        probs = (P.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5 + mask).softmax(dim=-1)
        return self.out_proj(P.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, c))


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = P.Linear(d, inner)
        self.fc2 = P.Linear(inner, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, d: int, heads: int, inner: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(d, heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, inner)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, max_len: int, d: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, d)
        self.position_embedding = nn.Embedding(max_len, d)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _TextModel(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.embeddings = _Embeddings(cfg["vocab_size"], cfg["max_position_embeddings"], d)
        self.encoder = _Encoder([CLIPLayer(d, cfg["num_attention_heads"], cfg["intermediate_size"], eps)
                                 for _ in range(cfg["num_hidden_layers"])])
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.text_model = _TextModel(cfg)

    def forward(self, ids):
        tm, n = self.text_model, ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[None, :n]
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# --------------------------------------------------------------- serve
class SDUpscaler(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.unet = UNet2DCondition(cfg["unet"])
        self.vae = AutoencoderKL(cfg["vae"])
        self.text_encoder = CLIPTextEncoder(cfg["text_encoder"])
        self.cfg = cfg


def scaled_linear_alphas_cumprod(sc: dict) -> np.ndarray:
    """diffusers' ``scaled_linear`` betas (linear in sqrt beta), float64."""
    betas = np.linspace(sc["beta_start"] ** 0.5, sc["beta_end"] ** 0.5, sc["num_train_timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def leading_timesteps(sc: dict, steps: int) -> tuple[list[int], int]:
    ratio = sc["num_train_timesteps"] // steps
    return [int(t) for t in (np.arange(steps) * ratio)[::-1] + sc["steps_offset"]], ratio


@torch.no_grad()
def serve(model: SDUpscaler, ids: torch.Tensor, lr_u8: torch.Tensor, latents: torch.Tensor,
          aug: torch.Tensor) -> torch.Tensor:
    """``ids``: the prompts' then the negative prompts' token ids (2N, 77);
    ``lr_u8`` NHWC uint8; ``latents`` (N, 4, h, w) and ``aug`` (N, 3, h, w)
    the initial latents and the augmentation noise -> NHWC float in [0, 1]."""
    cfg, serving = model.cfg, model.cfg["serving"]
    n = lr_u8.shape[0]
    img = lr_u8.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    states = model.text_encoder(ids)
    ctx = torch.cat([states[:n], states[n:]])
    nl = serving["noise_level"]
    lacp = scaled_linear_alphas_cumprod(cfg["low_res_scheduler"]).astype(np.float32)
    img_aug = float(np.sqrt(lacp[nl])) * img + float(np.sqrt(1.0 - lacp[nl])) * aug.float()
    sc = cfg["scheduler"]
    acp = scaled_linear_alphas_cumprod(sc).astype(np.float32)
    final = np.float32(1.0) if sc["set_alpha_to_one"] else acp[0]
    ts, ratio = leading_timesteps(sc, serving["steps"])
    gs, eta, one = serving["guidance_scale"], np.float32(serving["eta"]), np.float32(1.0)
    labels = torch.full((2 * n,), nl, dtype=torch.long, device=img.device)
    x = latents.float()
    for t in ts:
        inp = torch.cat([x, img_aug], dim=1)
        out = model.unet(torch.cat([inp, inp]), torch.full((2 * n,), t, dtype=torch.long, device=x.device),
                         ctx, labels)
        out_c, out_u = out.chunk(2)
        v = out_u + gs * (out_c - out_u)
        a_t = acp[t]
        a_prev = acp[t - ratio] if t - ratio >= 0 else final
        sq_a, sq_1ma = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        x0, eps = sq_a * x - sq_1ma * v, sq_a * v + sq_1ma * x
        sigma = eta * np.sqrt((one - a_prev) / (one - a_t)) * np.sqrt(one - a_t / a_prev)
        if sigma > 0:
            raise NotImplementedError("the reference serves eta 0 only")
        x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(max(one - a_prev - sigma * sigma, 0))) * eps
    out = model.vae.decode(x).clamp(-1.0, 1.0)
    return (out * 0.5 + 0.5).permute(0, 2, 3, 1)
