"""SRDiff building blocks (counterpart of the JAX package's
``models/layers.py:41-58``, ``:208-248`` and ``:326-744``).

Modules are NCHW with PyTorch's parameter layouts and the reference
checkpoint's names (``block.1`` is the conv of a Block and ``block.2`` its
GroupNorm when it has one, ``mlp.1`` the time Linear of a ResnetBlock,
``conv.0``/``conv.1`` the Upsample/Downsample convs, ``fn.g`` and
``fn.fn.to_qkv`` the mid attention's gate and projection). Parameters stay
float32; every forward casts them to the dtype of its input, which is the
compute dtype. GroupNorm Blocks (``groups`` > 0) and ``LinearAttention``
are off in the SRDiff config; the educational DDPM UNet runs its Blocks
with ``groups=8``. ``MultiheadAttention`` (JAX ``:746-858``), dead code in
the reference, is ported in plain tensor ops in PyTorch's parameter layout.
``BatchNorm`` and ``flax_init_`` give the educational models flax's
BatchNorm statistics and default initialisers.

The kernel gates (``chain_eligible`` ... ``rowpack_eligible``) read the JAX
package's environment switches, with its defaults, at every forward, so one
A/B configuration sets both packages. They keep its switches and channel
conditions and drop its TPU tile conditions (H, W multiples of 8 or 16, W >=
128, the backend check): the CUDA kernels take any H, W >= 2. They do not
look at the device either, so the CPU runs the same routing through the
kernels' plain versions. Under ``kernels_disabled()`` every gate returns
False.

Under a row split (``ops/rowsplit.py``, installed by ``parallel/mesh.py``
for a spatial call, with ``kernels_disabled()``) each member holds a run of
every activation's rows: ``reflect_pad1`` and ``conv`` take the
neighbours' rows at the inner edges (the reflect only at the image's top
and bottom; zeros there for zero-padded convs; a ConvT's input rows each
side, its output rows cropped), a Block's GroupNorm and
``LinearAttention``'s pixel softmax and context add their sums over the
members. 1x1 convs and everything per pixel need nothing.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.ops import rowsplit
from dgm_img_super_resolution_tpu_torch.ops.kernels._common import CHAIN_WIDTHS

_CHAIN_CHANNELS = (64,)
_KERNELS_FORCE_DISABLE = False


class kernels_disabled:
    """Context manager under which every kernel gate (``chain_eligible``,
    ``chain_stem_enabled``, ``chain_ds_enabled``, ``chain_head_enabled``,
    ``tail_eligible``, ``rowpack_eligible``) returns False, so every region
    runs its plain version: the counterpart of the JAX package's
    ``pallas_disabled`` (``models/layers.py:299-323``). Gates are read at
    every forward, so it holds for the calls made inside it. Re-entrant; the
    previous state comes back on exit."""

    def __enter__(self):
        global _KERNELS_FORCE_DISABLE
        self._prev = _KERNELS_FORCE_DISABLE
        _KERNELS_FORCE_DISABLE = True
        return self

    def __exit__(self, *exc):
        global _KERNELS_FORCE_DISABLE
        _KERNELS_FORCE_DISABLE = self._prev
        return False


# the kernel switches and their defaults: the gates below and routing_key read this table
_SWITCHES = {"DGMSR_PALLAS_FUSED": "1", "DGMSR_PALLAS_STEM": "1", "DGMSR_PALLAS_DS": "0", "DGMSR_PALLAS_HEAD": "0",
             "DGMSR_PALLAS_TAIL": "1", "DGMSR_PALLAS_CONV": "0"}


def _switch(name: str) -> bool:
    return os.environ.get(name, _SWITCHES[name]).lower() not in ("", "0", "false")


def routing_key() -> tuple:
    """Everything the gates below read: ``kernels_disabled()``, the
    switches and ``chain_channels()``. A captured graph (``core/graphs.py``)
    records the kernels of one routing, so its callers put this in its key."""
    return (_KERNELS_FORCE_DISABLE, chain_channels()) + tuple(_switch(name) for name in _SWITCHES)


def chain_channels() -> tuple[int, ...]:
    """ResnetBlock-pair widths routed to the chain kernels: ``DGMSR_CHAIN_C``
    (comma-separated), default 64. The port's chain kernels take every
    multiple of 32 from 32 to 512 (every stage of the hidden-32, -64 and
    -128 UNets at ``1|2|3|4``); naming another width raises, where the JAX
    package takes any width in interpret mode."""
    env = os.environ.get("DGMSR_CHAIN_C")
    chans = tuple(int(v) for v in env.split(",")) if env else _CHAIN_CHANNELS
    bad = sorted(set(chans) - set(CHAIN_WIDTHS))
    if bad:
        raise NotImplementedError(
            f"DGMSR_CHAIN_C={env}: the port's chain kernels take C in multiples of 32 "
            f"from 32 to 512, not C={', '.join(map(str, bad))}"
        )
    return chans


def chain_eligible(h: int, w: int, c: int) -> bool:
    """ResnetBlock pairs of width ``c`` go to the chain kernels
    (``DGMSR_PALLAS_FUSED``, default on)."""
    return (not _KERNELS_FORCE_DISABLE and _switch("DGMSR_PALLAS_FUSED") and c in chain_channels()
            and h >= 2 and w >= 2)


def chain_stem_enabled() -> bool:
    """Down stage 0's stem conv and 1x1 residual run inside the chain
    (``DGMSR_PALLAS_STEM``, default on)."""
    return not _KERNELS_FORCE_DISABLE and _switch("DGMSR_PALLAS_STEM")


def chain_ds_enabled() -> bool:
    """Down stage 0's Downsample folds into the stem chain
    (``DGMSR_PALLAS_DS``, default off)."""
    return not _KERNELS_FORCE_DISABLE and _switch("DGMSR_PALLAS_DS")


def chain_head_enabled(c_stream: int, dim_out: int) -> bool:
    """The up stage's head conv over ``[x || skip]`` and its 1x1 residual
    run inside the chain (``DGMSR_PALLAS_HEAD``, default off)."""
    return (not _KERNELS_FORCE_DISABLE and _switch("DGMSR_PALLAS_HEAD") and dim_out == 64
            and c_stream % 64 == 0 and c_stream <= 128)


def tail_eligible(h: int, w: int, c: int) -> bool:
    """The last Upsample, final Block and final 1x1 go to the tail kernel
    (``DGMSR_PALLAS_TAIL``, default on); ``h``/``w``/``c`` are the
    pre-upsample dims."""
    return (not _KERNELS_FORCE_DISABLE and _switch("DGMSR_PALLAS_TAIL") and c == 64
            and h >= 2 and w >= 2)


def rowpack_eligible(x: torch.Tensor, c_in: int, features: int) -> bool:
    """A C -> C reflect conv of a Block (no skip join) goes to the conv3x3
    kernel (``DGMSR_PALLAS_CONV``, default off), C in {32, 64}."""
    return (not _KERNELS_FORCE_DISABLE and _switch("DGMSR_PALLAS_CONV") and c_in == features
            and features in (32, 64) and x.ndim == 4 and x.shape[2] >= 2 and x.shape[3] >= 2)


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
    rows, then the left and right columns, corners included. Under a row
    split (``ops/rowsplit.py``) the neighbours' rows pad the inner edges."""
    if rowsplit.active() is not None:
        return rowsplit.reflect_pad1(x)
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
    """ReflectionPad(1) + 3x3 conv in the dtype of ``x``. Under a row split
    a stride-2 conv needs an even count of rows a member, so that every
    member's first row sits at an even image row."""
    dt = x.dtype
    if stride == 2 and rowsplit.active() is not None and x.shape[2] % 2:
        raise ValueError(f"a row split of a stride-2 conv needs an even count of rows a member, not {x.shape[2]}")
    return F.conv2d(
        reflect_pad1(x), weight.to(dt), None if bias is None else bias.to(dt), stride=stride,
    )


def conv(x, layer: nn.Conv2d | nn.ConvTranspose2d):
    """Apply a conv layer's params in the dtype of ``x``; under a row split
    (``ops/rowsplit.py``) over this member's rows, with its neighbours'."""
    dt = x.dtype
    w, b = layer.weight.to(dt), None if layer.bias is None else layer.bias.to(dt)
    if rowsplit.active() is not None and layer.kernel_size[0] > 1:
        if isinstance(layer, nn.ConvTranspose2d):
            return rowsplit.conv_transpose2d(x, w, b, layer.stride, layer.padding, layer.output_padding)
        return rowsplit.conv2d(x, w, b, layer.stride, layer.padding)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, layer.stride, layer.padding, layer.output_padding)
    return F.conv2d(x, w, b, layer.stride, layer.padding)


def linear(x, layer: nn.Linear):
    dt = x.dtype
    return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))


GN_EPS = 1e-6  # the JAX package's GroupNorm (flax's default epsilon)


class Block(nn.Module):
    """ReflectionPad(1) -> Conv3x3 -> [GroupNorm when ``groups`` > 0] -> Mish
    (``groups=0``, no norm, is the SRDiff config).

    ``joined``: ``x`` is the up stages' ``[x || skip]`` join, which the JAX
    package convolves as two inputs and never sends to the conv3x3 kernel."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 0):
        super().__init__()
        norm = [nn.GroupNorm(groups, dim_out, eps=GN_EPS)] if groups > 0 else []
        self.block = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(dim_in, dim_out, 3), *norm, Mish())
        self.groups = groups

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
        if self.groups <= 0:
            return self._conv(x, True, joined)
        gn = self.block[2]
        y = self._conv(x, False, joined).float()
        norm = rowsplit.group_norm if rowsplit.active() is not None else F.group_norm
        return mish(norm(y, self.groups, gn.weight, gn.bias, gn.eps).to(x.dtype))


class ResnetBlock(nn.Module):
    """2 x Block + time-embedding add + optional cond add + 1x1 residual.

    ``skip``: the up stages' skip tensor, joined after ``x`` on the channel
    axis (``[x || skip]``) as the input of block1 and of the residual conv."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int, groups: int = 0):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim_in, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
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


class LinearAttention(nn.Module):
    """O(h*w) linear attention: q, k, v from a bias-free 1x1 conv
    (channels ordered (qkv, head, d)), a softmax of k over the pixels, the
    context k v^T per head, the output context^T q, then a 1x1 conv."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = conv(x, self.to_qkv).reshape(b, 3, self.heads, self.dim_head, h * w)
        q, k, v = qkv.unbind(1)
        if rowsplit.active() is None:
            context = torch.einsum("bhdn,bhen->bhde", k.softmax(dim=-1), v)
        else:  # the softmax and the context over the whole image's pixels
            context = rowsplit.all_sum(torch.einsum("bhdn,bhen->bhde", rowsplit.pixel_softmax(k), v))
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return conv(out.reshape(b, self.heads * self.dim_head, h, w), self.to_out)


class Rezero(nn.Module):
    """fn(x) * g, with the scalar gate g starting at 0."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.fn(x) * self.g.to(x.dtype)


class Residual(nn.Module):
    """x + fn(x)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """x where x >= 0, else slope * x (JAX ``models/layers.py:861``; its
    gradient at 0 is 1, as JAX's)."""
    return torch.where(x >= 0, x, negative_slope * x)


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero-pad H and W as flax's ``padding="SAME"`` does for a k x k conv
    at stride s: ``max((ceil(n / s) - 1) * s + k - n, 0)`` in all, the odd
    one at the high side (so a stride-2 3x3 on an even side pads only its
    high side, unlike ``Conv2d(padding=1)``)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the channels of an NCHW tensor: in
    training the batch's mean and biased variance normalise it and move the
    running statistics as ``ra = momentum * ra + (1 - momentum) * batch``
    (flax's momentum 0.99, which is torch's 0.01), with the *biased*
    variance where ``nn.BatchNorm2d`` moves them with the unbiased one; in
    eval the running statistics normalise. State dict: ``weight`` (flax's
    ``scale``), ``bias``, ``running_mean``, ``running_var``."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0,
                                self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.ndim))
            var, mean = torch.var_mean(x.detach(), dim=dims, correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator, kernel_std: float | None = None,
               norm_scale_std: float | None = None) -> nn.Module:
    """Draw ``model``'s parameters in place as flax's defaults do: conv,
    transposed-conv and dense kernels LeCun-normal (a normal truncated at 2
    sigma, scaled to std 1/sqrt(fan_in)) or N(0, ``kernel_std``), biases 0;
    norm scales 1 or N(0, ``norm_scale_std``), norm biases 0;
    ``MultiheadAttention`` as its own ``reset_parameters``."""
    from dgm_img_super_resolution_tpu_torch.models.factory import fan_in

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if kernel_std is None:
                std = 1.0 / math.sqrt(fan_in(mod)) / 0.87962566103423978  # flax's truncation factor
                w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std, -2 * std, 2 * std,
                                                    generator=generator))
            else:
                w.copy_(torch.randn(w.shape, generator=generator) * kernel_std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.GroupNorm, BatchNorm)):
            if norm_scale_std is None:
                mod.weight.fill_(1.0)
            else:
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * norm_scale_std)
            mod.bias.zero_()
        elif isinstance(mod, MultiheadAttention):
            mod.reset_parameters(generator)
    return model


class MultiheadAttention(nn.Module):
    """Fairseq-style multi-head attention over batch-first ``(B, T, E)``
    tensors (JAX ``models/layers.py:746-858``; the reference's
    ``srdiff/model.py:525-667``, a wrapper of
    ``F.multi_head_attention_forward``), in plain tensor ops.

    Parameters in PyTorch's layout: ``in_proj_weight`` (3E, E) and
    ``in_proj_bias`` (3E) for the packed q, k, v projections, ``out_proj``
    a Linear, and with ``add_bias_kv`` ``bias_k`` / ``bias_v`` (1, 1, E),
    appended as one more key position. ``add_zero_attn`` appends a zero key
    and value. ``key_padding_mask`` (B, Tk) is True (or 1) where a key is
    padding; ``attn_mask`` (Tq, Tk) is additive, or boolean with True
    masked. Returns ``(out, weights)``: the weights averaged over heads
    (``need_weights``), per head (``need_head_weights``), or None; with
    ``before_softmax`` the logits (B, H, Tq, Tk) and v (B, Tk, H, d)
    instead. No dropout (the reference never trains it)."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, add_bias_kv: bool = False,
                 add_zero_attn: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.add_zero_attn = embed_dim, num_heads, add_zero_attn
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim)) if bias else None
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias)
        if add_bias_kv:
            self.bias_k = nn.Parameter(torch.empty(1, 1, embed_dim))
            self.bias_v = nn.Parameter(torch.empty(1, 1, embed_dim))
        else:
            self.bias_k = self.bias_v = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Xavier-uniform projections, zero biases, N(0, 0.02) bias_k/v (JAX's
        initialisers)."""
        e = self.embed_dim
        for w, fan in ((self.in_proj_weight, (e, 3 * e)), (self.out_proj.weight, (e, e))):
            bound = math.sqrt(6.0 / sum(fan))
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)
        for b in (self.in_proj_bias, self.out_proj.bias):
            if b is not None:
                b.zero_()
        for b in (self.bias_k, self.bias_v):
            if b is not None:
                b.copy_(torch.randn(b.shape, generator=generator) * 0.02)

    def forward(self, query, key=None, value=None, key_padding_mask=None, need_weights: bool = True,
                attn_mask=None, before_softmax: bool = False, need_head_weights: bool = False):
        need_weights = need_weights or need_head_weights
        key = query if key is None else key
        value = key if value is None else value
        e, h = self.embed_dim, self.num_heads
        d = e // h
        b, tq, _ = query.shape
        dt = query.dtype
        w = self.in_proj_weight.to(dt)
        bq, bk, bv = (None,) * 3 if self.in_proj_bias is None else self.in_proj_bias.to(dt).chunk(3)
        q = F.linear(query, w[:e], bq) * d ** -0.5
        k = F.linear(key, w[e:2 * e], bk)
        v = F.linear(value, w[2 * e:], bv)

        def extend(k, v, k_row, v_row, attn_mask, key_padding_mask):
            k = torch.cat([k, k_row.to(k.dtype).expand(b, 1, e)], 1)
            v = torch.cat([v, v_row.to(v.dtype).expand(b, 1, e)], 1)
            if attn_mask is not None:
                attn_mask = F.pad(attn_mask, (0, 1))
            if key_padding_mask is not None:
                key_padding_mask = F.pad(key_padding_mask, (0, 1))
            return k, v, attn_mask, key_padding_mask

        if self.bias_k is not None:
            k, v, attn_mask, key_padding_mask = extend(k, v, self.bias_k, self.bias_v, attn_mask, key_padding_mask)
        if self.add_zero_attn:
            zero = torch.zeros(1, 1, e, dtype=k.dtype, device=k.device)
            k, v, attn_mask, key_padding_mask = extend(k, v, zero, zero, attn_mask, key_padding_mask)
        tk = k.shape[1]
        q, k, v = q.reshape(b, tq, h, d), k.reshape(b, tk, h, d), v.reshape(b, tk, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                logits = logits.masked_fill(attn_mask[None, None], float("-inf"))
            else:
                logits = logits + attn_mask[None, None].float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask.bool()[:, None, None, :], float("-inf"))
        if before_softmax:
            return logits, v
        probs = logits.softmax(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(b, tq, e)
        out = F.linear(out, self.out_proj.weight.to(out.dtype),
                       None if self.out_proj.bias is None else self.out_proj.bias.to(out.dtype))
        if not need_weights:
            return out, None
        return out, probs if need_head_weights else probs.mean(dim=1)
