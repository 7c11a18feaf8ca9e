"""The ResnetBlock-pair chain regions of the UNet (counterpart of the JAX
package's ``ops/pallas/block_chain.py``).

``block_chain3_stem`` is down stage 0 (stem conv 3->C, 1x1 residual conv and
the three chained reflect 3x3 C->C convs, plus the RRDB condition);
``block_chain3_stem_ds`` is the same with the stage's Downsample folded in;
``block_chain3`` is the chain from ``h1`` on, for every other ResnetBlock
pair of a width in the chain set, and ``block_chain3_head`` the same with
the stage's head conv over ``[x || skip]`` and its 1x1 residual conv in
front. Each has a plain PyTorch version (the CPU path, and the yardstick the
card is held against) and hand-written CUDA kernels for CUDA tensors, chosen
by dtype and width. The chain runs in bfloat16 at C = 64, 128, 192 and 256
(``CORE_WIDTHS``) on the warpgroup-MMA conv core
(``csrc/block_chain_wgmma.cu``: the stem writing h1, or an h1 pass over an
a_pre made outside, then three conv launches; weights resident at C = 64,
streamed in 64-channel slices above, ``csrc/conv_wgmma_wide.cuh``). Float32
at C = 32 and 64 and bfloat16 at C = 32 run ``csrc/block_chain.cu``'s tiled
conv; float32 from 96 on and bfloat16 at the other multiples of 32 (96,
160, 224, 288-512) run ``csrc/chain_wide.cu``. In bf16 the Downsample
(stride 2, C = 64) and the head over ``[x || skip]`` (C_s in
``HEAD_CORE_WIDTHS``, writing the chain's h1 and r1 in one launch) run on
the same core (``csrc/head_ds_wgmma.cu``); float32, and the head at other
C_s, on ``block_chain.cu``'s streamed conv. A failed build or launch
raises: no route falls back to another. Each wrapper's ``launches`` counts
its calls on the card, ``launches_wgmma`` those whose chain ran on the core,
``block_chain3_stem_ds.launches_ds_wgmma`` and
``block_chain3_head.launches_head_wgmma`` those whose Downsample or head
did; ``block_chain3.launches_by_shape`` counts its calls by (C, H, W).
Tensors are NCHW-shaped; on the card activations must be ``channels_last``
so that the kernels see NHWC memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import mish, reflect_conv3x3
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._autograd import region
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def h1_plain(a_pre, tv1):
    """h1 = mish(a_pre) + tv1, rounded to the activation dtype: the chain's
    input (the stem launch writes it; the h1 pass of the core's route)."""
    return (mish(a_pre.float()) + _vec(tv1).float()).to(a_pre.dtype)


def chain_from_h1_plain(h1, r1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """The chain's three convs from h1 on, rounding y1, h2 and out to the
    activation dtype where the reference does (the core's three launches)."""
    dt = h1.dtype
    y1 = mish(reflect_conv3x3(h1, wb, bb).float()).to(dt) + r1
    h2 = (mish(reflect_conv3x3(y1, wc, bc).float()) + _vec(tv2).float()).to(dt)
    out = mish(reflect_conv3x3(h2, wd, bd).float()).to(dt) + y1
    if cond is not None:
        out = out + cond
    return out


def stem_plain(x, wa, ba, wr, br):
    """Down stage 0's stem: a_pre = reflect 3x3 conv (3->C), r1 = 1x1
    residual conv (3->C), each rounded once."""
    return reflect_conv3x3(x, wa, ba), F.conv2d(x, wr.to(x.dtype), br.to(x.dtype))


def stem_h1_plain(x, wa, ba, wr, br, tv1):
    """(h1, r1) of the stem: what the stem launch writes on the core's route."""
    a_pre, r1 = stem_plain(x, wa, ba, wr, br)
    return h1_plain(a_pre, tv1), r1


def block_chain3_plain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """Plain composition (``block_chain3_reference``): h1, then the chain."""
    return chain_from_h1_plain(h1_plain(a_pre, tv1), r1, tv2, wb, bb, wc, bc, wd, bd, cond)


def block_chain3_stem_plain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """Plain composition (``block_chain3_stem_reference``): the stem's a_pre
    and r1, then the chain."""
    a_pre, r1 = stem_plain(x, wa, ba, wr, br)
    return block_chain3_plain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)


def ds_plain(out, wds, bds):
    """Down stage 0's Downsample: reflect 3x3 conv at stride 2, rounded once
    (the Downsample launch on the core's route)."""
    return reflect_conv3x3(out, wds, bds, stride=2)


def block_chain3_stem_ds_plain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond, wds, bds):
    """Plain composition (``block_chain3_stem_ds_reference``): the stem
    chain, then down stage 0's Downsample (reflect 3x3, stride 2) on its
    output. Returns ``(out, ds_out)``."""
    out = block_chain3_stem_plain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    return out, ds_plain(out, wds, bds)


def head_plain(x, skip, wa, ba, wr, br):
    """The head over ``[x || skip]``: (a_pre, r1), the reflect 3x3 conv and
    the 1x1 residual conv each computed as its x part plus its skip part,
    rounded where the reference rounds."""
    dt, cs = x.dtype, x.shape[1]
    a_pre = reflect_conv3x3(x, wa[:, :cs], ba) + reflect_conv3x3(skip, wa[:, cs:])
    r1 = F.conv2d(x, wr[:, :cs].to(dt)) + F.conv2d(skip, wr[:, cs:].to(dt)) + _vec(br[None].to(dt))
    return a_pre, r1


def head_h1_plain(x, skip, wa, ba, wr, br, tv1):
    """(h1, r1) of the head: what the head launch writes on the core's route."""
    a_pre, r1 = head_plain(x, skip, wa, ba, wr, br)
    return h1_plain(a_pre, tv1), r1


def block_chain3_head_plain(x, skip, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd):
    """Plain composition (``block_chain3_head_reference``): the head's a_pre
    and r1, then the chain."""
    a_pre, r1 = head_plain(x, skip, wa, ba, wr, br)
    return block_chain3_plain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd)


RESIDENT_WIDTHS = (32, 64)  # chain widths whose weights stay in shared memory (block_chain.cu)
CORE_WIDTHS = (64, 128, 192, 256)  # bf16 chain widths on the conv core (block_chain_wgmma.cu)
HEAD_CORE_WIDTHS = (64, 128)  # C_s of the bf16 head on the conv core (head_ds_wgmma.cu)


def _on_core(t: torch.Tensor) -> bool:
    """Whether the chain over activations like ``t`` runs on the
    warpgroup-MMA conv core (``csrc/block_chain_wgmma.cu``): bf16 at a
    width in ``CORE_WIDTHS``."""
    return t.dtype == torch.bfloat16 and t.shape[1] in CORE_WIDTHS


def stream_taps(w: torch.Tensor, dtype: torch.dtype, ks: int = 64) -> torch.Tensor:
    """(C_out, C_in, k, k) conv weight -> (C_in / ks, k * k, C_out, ks) in
    ``dtype``: one (tap, C_out, ks) slab per ks-channel slice of the input,
    the layout of the weight-streaming convs (``csrc/block_chain.cu:
    conv_stream_kernel``, ks = 64; ``csrc/chain_wide.cu``, ks = 32)."""
    co, ci, kh, kw = w.shape
    w = w.reshape(co, ci // ks, ks, kh, kw).permute(1, 3, 4, 0, 2)
    return w.reshape(ci // ks, kh * kw, co, ks).to(dtype).contiguous()


def _check_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    K.dtype_code(a_pre)
    b, c, h, w = a_pre.shape
    K.check_width(c, h, w, K.CHAIN_WIDTHS)
    for name, t in (("a_pre", a_pre), ("r1", r1), ("cond", cond)):
        if t is not None:
            K.check_act(name, t, (b, c, h, w), a_pre.dtype)
    for name, t in (("tv1", tv1), ("tv2", tv2)):
        K.check_param(name, t, (b, c))
    for name, t in (("wb", wb), ("wc", wc), ("wd", wd)):
        K.check_param(name, t, (c, c, 3, 3))
    for name, t in (("bb", bb), ("bc", bc), ("bd", bd)):
        K.check_param(name, t, (c,))


def _launch_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    """Three tiled-conv launches, conv_b building h1 in its input prologue:
    of the resident-weight kernel at C in ``RESIDENT_WIDTHS``, of the wide
    kernel (weights streamed over K in 32-channel slices, 64 or 32 output
    channels a block) above: float32, and bf16 off ``CORE_WIDTHS``."""
    b, c, h, w = a_pre.shape
    dt = a_pre.dtype
    y1 = torch.empty_like(a_pre)
    h2 = torch.empty_like(a_pre)
    out = torch.empty_like(a_pre)
    if c in RESIDENT_WIDTHS:
        taps, fn = K.conv_taps, function("block_chain", "dgmsr_block_chain3", 14, 4)
    else:
        taps, fn = lambda w_, d: stream_taps(w_, d, 32), function("chain_wide", "dgmsr_chain_wide", 14, 4)
    args = [K.f32(tv1, dt), K.f32(tv2, dt), taps(wb, dt), K.f32(bb, dt),
            taps(wc, dt), K.f32(bc, dt), taps(wd, dt), K.f32(bd, dt)]
    rc = fn(K.dtype_code(a_pre), a_pre.data_ptr(), r1.data_ptr(),
            *(t.data_ptr() for t in args),
            cond.data_ptr() if cond is not None else None,
            y1.data_ptr(), h2.data_ptr(), out.data_ptr(), c, b, h, w, K.stream_ptr())
    K.raise_on_error(rc, f"block_chain3 (C={c})")
    return out


def _launch_h1(a_pre, tv1):
    """The h1 pass of the core's route, where a_pre comes from outside."""
    b, c, h, w = a_pre.shape
    h1 = torch.empty_like(a_pre)
    tv1_k = K.f32(tv1, a_pre.dtype)
    fn = function("block_chain_wgmma", "dgmsr_h1", 3, 4)
    rc = fn(K.dtype_code(a_pre), a_pre.data_ptr(), tv1_k.data_ptr(), h1.data_ptr(), c, b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain3 (h1 pass)")
    return h1


def _launch_chain_core(h1, r1, tv2, wb, bb, wc, bc, wd, bd, cond):
    """conv_b, conv_c and conv_d on the conv core. h1 is the wrapper's own
    scratch: conv_c writes h2 over it."""
    b, c, h, w = h1.shape
    dt = h1.dtype
    y1 = torch.empty_like(h1)
    out = torch.empty_like(h1)
    args = [K.f32(tv2, dt), K.conv_taps(wb, dt), K.f32(bb, dt), K.conv_taps(wc, dt), K.f32(bc, dt),
            K.conv_taps(wd, dt), K.f32(bd, dt)]
    fn = function("block_chain_wgmma", "dgmsr_chain3_wgmma", 13, 4)
    rc = fn(K.dtype_code(h1), h1.data_ptr(), r1.data_ptr(), *(t.data_ptr() for t in args),
            cond.data_ptr() if cond is not None else None, y1.data_ptr(), h1.data_ptr(), out.data_ptr(),
            c, b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain3 (conv core)")
    return out


def _chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    """The chain over an a_pre made outside it; (out, whether it ran on the
    conv core)."""
    _check_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    if _on_core(a_pre):
        return _launch_chain_core(_launch_h1(a_pre, tv1), r1, tv2, wb, bb, wc, bc, wd, bd, cond), True
    return _launch_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond), False


def block_chain3(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """The chain from h1 on (see :func:`block_chain3_plain`). ``a_pre``,
    ``r1``, ``cond``: (B,C,H,W) activations; ``tv1``/``tv2``: (B,C) time
    vectors; ``w*``/``b*``: (C,C,3,3)/(C,) conv params; C a multiple of 32
    from 32 to 512. CPU tensors run the plain version; CUDA tensors launch
    the kernel (3 conv launches), differentiable through the plain version
    (``_autograd.region``). ``launches`` counts every call,
    ``launches_by_shape`` those at each (C, H, W), ``launches_wgmma`` the
    calls on the conv core (bf16 at a width in ``CORE_WIDTHS``: an h1 pass
    and 3 conv launches)."""
    args = (a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    if K.on_cpu(*args):
        return block_chain3_plain(*args)
    return region(_block_chain3_cuda, block_chain3_plain, *args)


def _block_chain3_cuda(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    out, core = _chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    _, c, h, w = a_pre.shape
    block_chain3.launches += 1
    block_chain3.launches_wgmma += core
    block_chain3.launches_by_shape[c, h, w] = block_chain3.launches_by_shape.get((c, h, w), 0) + 1
    return out


block_chain3.launches = 0
block_chain3.launches_wgmma = 0
block_chain3.launches_by_shape = {}


def _launch_stem(x, wa, ba, wr, br, tv1=None):
    """The stem launch of down stage 0's first ResnetBlock: (h1, r1) in
    bf16, on the core's route (``tv1`` given), else (a_pre, r1)."""
    dt = x.dtype
    code = K.dtype_code(x)
    b, cin, h, w = x.shape
    c = wa.shape[0]
    K.check_width(c, h, w)
    K.check_act("x", x, (b, 3, h, w), dt)
    K.check_param("wa", wa, (c, 3, 3, 3))
    K.check_param("wr", wr, (c, 3, 1, 1))
    for name, t in (("ba", ba), ("br", br)):
        K.check_param(name, t, (c,))
    first = torch.empty((b, c, h, w), dtype=dt, device=x.device, memory_format=torch.channels_last)
    r1 = torch.empty_like(first)
    # weights rounded to the activation dtype, as the plain version's conv sees them
    wa_k = K.f32(wa.permute(2, 3, 1, 0).reshape(27, c), dt)
    wr_k = K.f32(wr[:, :, 0, 0].t(), dt)
    ptrs = [x, wa_k, K.f32(ba, dt), wr_k, K.f32(br, dt)]
    if tv1 is not None:
        K.check_param("tv1", tv1, (b, c))
        fn = function("block_chain_wgmma", "dgmsr_stem_h1", 8, 3)
        ptrs.append(K.f32(tv1, dt))
    else:
        fn = function("block_chain", "dgmsr_stem_head", 7, 3)
    rc = fn(code, *(t.data_ptr() for t in ptrs), first.data_ptr(), r1.data_ptr(), b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain3_stem (stem)")
    return first, r1


def _stem_chain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    """The stem launch, then the chain; (out, whether it ran on the conv
    core). bf16 takes the core's route (the stem is C = 64 only)."""
    if x.dtype == torch.bfloat16:
        h1, r1 = _launch_stem(x, wa, ba, wr, br, tv1)
        _check_chain(h1, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
        return _launch_chain_core(h1, r1, tv2, wb, bb, wc, bc, wd, bd, cond), True
    a_pre, r1 = _launch_stem(x, wa, ba, wr, br)
    return _chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)


def block_chain3_stem(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """Down stage 0 (see :func:`block_chain3_stem_plain`). ``x``: (B,3,H,W)
    noisy residual in the activation dtype; ``wa``/``ba``: (C,3,3,3)/(C,)
    stem conv; ``wr``/``br``: (C,3,1,1)/(C,) residual conv; the rest as
    :func:`block_chain3`. CUDA tensors launch the kernel: a stem launch and 3
    conv launches (bf16 on the conv core: the stem writes h1)."""
    args = (x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    if K.on_cpu(*args):
        return block_chain3_stem_plain(*args)
    return region(_block_chain3_stem_cuda, block_chain3_stem_plain, *args)


def _block_chain3_stem_cuda(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    out, core = _stem_chain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    block_chain3_stem.launches += 1
    block_chain3_stem.launches_wgmma += core
    return out


block_chain3_stem.launches = 0
block_chain3_stem.launches_wgmma = 0


def block_chain3_stem_ds(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond, wds, bds):
    """Down stage 0 with its Downsample folded in (see
    :func:`block_chain3_stem_ds_plain`): the arguments of
    :func:`block_chain3_stem`, then ``wds``/``bds``, the (C,C,3,3)/(C,)
    stride-2 conv. Returns ``(out, ds_out)``; H and W must be even. CUDA
    tensors launch the kernel: the stem's 4 launches and a stride-2 conv
    launch, in bf16 on the conv core (``csrc/head_ds_wgmma.cu``, counted in
    ``launches_ds_wgmma``), in float32 on ``block_chain.cu``."""
    args = (x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond, wds, bds)
    if K.on_cpu(*args):
        return block_chain3_stem_ds_plain(*args)
    return region(_block_chain3_stem_ds_cuda, block_chain3_stem_ds_plain, *args)


def _launch_ds(out, wds, bds):
    """The Downsample launch over the chain's output: bf16 on the conv core
    at stride 2 (``csrc/head_ds_wgmma.cu``, weights ``K.conv_taps``),
    float32 on ``block_chain.cu``'s streamed conv (``stream_taps``)."""
    b, c, h, w = out.shape
    dt = out.dtype
    ds = torch.empty((b, c, h // 2, w // 2), dtype=dt, device=out.device, memory_format=torch.channels_last)
    if dt == torch.bfloat16:
        wds_k, fn = K.conv_taps(wds, dt), function("head_ds_wgmma", "dgmsr_ds_wgmma", 4, 3)
    else:
        wds_k, fn = stream_taps(wds, dt), function("block_chain", "dgmsr_stem_ds", 4, 3)
    rc = fn(K.dtype_code(out), out.data_ptr(), wds_k.data_ptr(), K.f32(bds, dt).data_ptr(), ds.data_ptr(), b, h, w,
            K.stream_ptr())
    K.raise_on_error(rc, "block_chain3_stem_ds (Downsample)")
    return ds


def _block_chain3_stem_ds_cuda(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond, wds, bds):
    _, _, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"the Downsample fold needs even H, W, got {h}x{w}")
    c = wa.shape[0]
    K.check_param("wds", wds, (c, c, 3, 3))
    K.check_param("bds", bds, (c,))
    out, core = _stem_chain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    ds = _launch_ds(out, wds, bds)
    block_chain3_stem_ds.launches += 1
    block_chain3_stem_ds.launches_wgmma += core
    block_chain3_stem_ds.launches_ds_wgmma += x.dtype == torch.bfloat16
    return out, ds


block_chain3_stem_ds.launches = 0
block_chain3_stem_ds.launches_wgmma = 0
block_chain3_stem_ds.launches_ds_wgmma = 0


def block_chain3_head(x, skip, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd):
    """The last up stage with its head in front (see
    :func:`block_chain3_head_plain`). ``x``/``skip``: (B,C_s,H,W), the
    upsampled activation and the down path's skip; ``wa``/``ba``:
    (C,2C_s,3,3)/(C,) head conv; ``wr``/``br``: (C,2C_s,1,1)/(C,) residual
    conv; the rest as :func:`block_chain3`; C_s must be a multiple of 64.
    CUDA tensors launch the kernel: in bf16 at C_s in ``HEAD_CORE_WIDTHS``
    one head launch on the conv core writing h1 and r1
    (``csrc/head_ds_wgmma.cu``, counted in ``launches_head_wgmma``), then
    the chain's three core launches; otherwise two head launches on
    ``block_chain.cu`` writing a_pre and r1, then the chain as
    :func:`block_chain3` launches it."""
    args = (x, skip, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd)
    if K.on_cpu(*args):
        return block_chain3_head_plain(*args)
    return region(_block_chain3_head_cuda, block_chain3_head_plain, *args)


def _launch_head(x, skip, wa, ba, wr, br, tv1=None):
    """The head's launches: (h1, r1) from one launch on the conv core
    (``tv1`` given: bf16, C_s in ``HEAD_CORE_WIDTHS``), else (a_pre, r1) from
    ``block_chain.cu``'s two streamed convs."""
    dt = x.dtype
    b, cs, h, w = x.shape
    c = wa.shape[0]
    first = torch.empty((b, c, h, w), dtype=dt, device=x.device, memory_format=torch.channels_last)
    r1 = torch.empty_like(first)
    if tv1 is not None:
        K.check_param("tv1", tv1, (b, c))
        args = [K.conv_taps(wa, dt), K.f32(ba, dt), wr[:, :, 0, 0].to(dt).contiguous(), K.f32(br, dt), K.f32(tv1, dt)]
        fn = function("head_ds_wgmma", "dgmsr_head_wgmma", 9, 4)
    else:
        args = [stream_taps(wa, dt), K.f32(ba, dt), stream_taps(wr, dt), K.f32(br, dt)]
        fn = function("block_chain", "dgmsr_head", 8, 4)
    rc = fn(K.dtype_code(x), x.data_ptr(), skip.data_ptr(), *(t.data_ptr() for t in args), first.data_ptr(),
            r1.data_ptr(), cs, b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain3_head (head)")
    return first, r1


def _block_chain3_head_cuda(x, skip, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd):
    dt = x.dtype
    K.dtype_code(x)
    b, cs, h, w = x.shape
    c = wa.shape[0]
    K.check_width(c, h, w)
    if cs % 64:
        raise ValueError(f"the head kernel takes C_s in multiples of 64, got C_s={cs}")
    K.check_act("x", x, (b, cs, h, w), dt)
    K.check_act("skip", skip, (b, cs, h, w), dt)
    K.check_param("wa", wa, (c, 2 * cs, 3, 3))
    K.check_param("wr", wr, (c, 2 * cs, 1, 1))
    for name, t in (("ba", ba), ("br", br)):
        K.check_param(name, t, (c,))
    head_core = dt == torch.bfloat16 and cs in HEAD_CORE_WIDTHS
    if head_core:
        h1, r1 = _launch_head(x, skip, wa, ba, wr, br, tv1)
        _check_chain(h1, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, None)
        out, core = _launch_chain_core(h1, r1, tv2, wb, bb, wc, bc, wd, bd, None), True
    else:
        a_pre, r1 = _launch_head(x, skip, wa, ba, wr, br)
        out, core = _chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, None)
    block_chain3_head.launches += 1
    block_chain3_head.launches_wgmma += core
    block_chain3_head.launches_head_wgmma += head_core
    return out


block_chain3_head.launches = 0
block_chain3_head.launches_wgmma = 0
block_chain3_head.launches_head_wgmma = 0
