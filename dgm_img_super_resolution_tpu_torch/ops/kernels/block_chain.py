"""The ResnetBlock-pair chain regions of the UNet (counterpart of the JAX
package's ``ops/pallas/block_chain.py``).

``block_chain3_stem`` is down stage 0 (stem conv 3->C, 1x1 residual conv and
the three chained reflect 3x3 C->C convs, plus the RRDB condition);
``block_chain3`` is the same chain from ``h1`` on, for the last up stage.
Each has a plain PyTorch version (the CPU path, and the yardstick the card
is held against) and a hand-written CUDA kernel in ``csrc/block_chain.cu``
for CUDA tensors. Tensors are NCHW-shaped; on the card activations must be
``channels_last`` so that the kernels see NHWC memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import mish, reflect_conv3x3
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def block_chain3_plain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """Plain composition (``block_chain3_reference``): rounds h1, y1, h2 and
    out to the activation dtype where the reference does."""
    dt = a_pre.dtype
    h1 = (mish(a_pre.float()) + _vec(tv1).float()).to(dt)
    y1 = mish(reflect_conv3x3(h1, wb, bb).float()).to(dt) + r1
    h2 = (mish(reflect_conv3x3(y1, wc, bc).float()) + _vec(tv2).float()).to(dt)
    out = mish(reflect_conv3x3(h2, wd, bd).float()).to(dt) + y1
    if cond is not None:
        out = out + cond
    return out


def block_chain3_stem_plain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """Plain composition (``block_chain3_stem_reference``): a_pre = reflect
    3x3 stem conv (3->C), r1 = 1x1 residual conv (3->C), then the chain."""
    a_pre = reflect_conv3x3(x, wa, ba)
    r1 = F.conv2d(x, wr.to(x.dtype), br.to(x.dtype))
    return block_chain3_plain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)


def _check_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
    K.dtype_code(a_pre)
    b, c, h, w = a_pre.shape
    K.check_width(c, h, w)
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
    b, c, h, w = a_pre.shape
    dt = a_pre.dtype
    y1 = torch.empty_like(a_pre)
    h2 = torch.empty_like(a_pre)
    out = torch.empty_like(a_pre)
    args = [K.f32(tv1, dt), K.f32(tv2, dt), K.conv_taps(wb, dt), K.f32(bb, dt),
            K.conv_taps(wc, dt), K.f32(bc, dt), K.conv_taps(wd, dt), K.f32(bd, dt)]
    fn = function("block_chain", "dgmsr_block_chain3", 14, 3)
    rc = fn(K.dtype_code(a_pre), a_pre.data_ptr(), r1.data_ptr(),
            *(t.data_ptr() for t in args),
            cond.data_ptr() if cond is not None else None,
            y1.data_ptr(), h2.data_ptr(), out.data_ptr(), b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain3")
    return out


def block_chain3(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """The chain from h1 on (see :func:`block_chain3_plain`). ``a_pre``,
    ``r1``, ``cond``: (B,C,H,W) activations; ``tv1``/``tv2``: (B,C) time
    vectors; ``w*``/``b*``: (C,C,3,3)/(C,) conv params. CPU tensors run the
    plain version; CUDA tensors launch the kernel (3 tiled-conv launches)."""
    if K.on_cpu(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
        return block_chain3_plain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    _check_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    out = _launch_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    block_chain3.launches += 1
    return out


block_chain3.launches = 0


def block_chain3_stem(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond=None):
    """Down stage 0 (see :func:`block_chain3_stem_plain`). ``x``: (B,3,H,W)
    noisy residual in the activation dtype; ``wa``/``ba``: (C,3,3,3)/(C,)
    stem conv; ``wr``/``br``: (C,3,1,1)/(C,) residual conv; the rest as
    :func:`block_chain3`. CUDA tensors launch the kernel (a stem launch and
    3 tiled-conv launches)."""
    if K.on_cpu(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond):
        return block_chain3_stem_plain(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
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
    a_pre = torch.empty((b, c, h, w), dtype=dt, device=x.device, memory_format=torch.channels_last)
    r1 = torch.empty_like(a_pre)
    # weights rounded to the activation dtype, as the plain version's conv sees them
    wa_k = K.f32(wa.permute(2, 3, 1, 0).reshape(27, c), dt)
    wr_k = K.f32(wr[:, :, 0, 0].t(), dt)
    ba_k, br_k = K.f32(ba, dt), K.f32(br, dt)
    fn = function("block_chain", "dgmsr_stem_head", 7, 3)
    rc = fn(code, x.data_ptr(), wa_k.data_ptr(), ba_k.data_ptr(), wr_k.data_ptr(), br_k.data_ptr(),
            a_pre.data_ptr(), r1.data_ptr(), b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain3_stem (stem)")
    _check_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    out = _launch_chain(a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond)
    block_chain3_stem.launches += 1
    return out


block_chain3_stem.launches = 0
