"""The UNet tail region (counterpart of the JAX package's
``ops/pallas/tail_fuse.py``): the last Upsample's ConvTranspose(k4, s2, p1),
the final Block (reflect 3x3 conv + Mish) and the final 1x1 conv.

``tail_fuse`` runs the plain PyTorch version on CPU tensors and hand-written
CUDA kernels on CUDA tensors, chosen by dtype and shape: bfloat16 with at
most ``CORE_COUT`` output channels runs on the warpgroup-MMA conv core
(``csrc/tail_fuse_wgmma.cu``: a ConvT launch writing y, then the core's
reflect 3x3 whose epilogue hook applies Mish and the 1x1 conv); float32, and
bfloat16 with more output channels, run ``csrc/tail_fuse.cu``'s tiled conv
(``conv_tile.cuh``). A failed build or launch raises: no route falls back to
another. ``tail_fuse.launches`` counts every call on the card,
``tail_fuse.launches_wgmma`` those on the conv core. Weights are in
PyTorch's layouts: ``wt`` is a ``ConvTranspose2d`` weight (C_in, C_out, 4,
4), not flipped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import mish, reflect_conv3x3
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._autograd import region
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function

CORE_COUT = 8  # the most output channels the conv core's 1x1 hook stores


def convt_plain(x, wt, bt):
    """The tail's first piece: y = ConvT(k4, s2, p1)(x) + bt, in the
    activation dtype (the core route's ConvT launch)."""
    dt = x.dtype
    return F.conv_transpose2d(x, wt.to(dt), bt.to(dt), stride=2, padding=1)


def conv_mish_1x1_plain(y, wf, bf, wo, bo):
    """The tail's second piece: reflect 3x3 + bias + Mish, then the 1x1 conv
    + bias, rounded where ``tail_reference`` rounds (the core route's conv
    launch with its 1x1 hook)."""
    dt = y.dtype
    m = mish(reflect_conv3x3(y, wf, bf).float()).to(dt)
    return F.conv2d(m, wo.to(dt), bo.to(dt))


def tail_fuse_plain(x, wt, bt, wf, bf, wo, bo):
    """Plain composition (``tail_reference``): ConvT + bias -> reflect 3x3 +
    bias + Mish -> 1x1 + bias, in the activation dtype."""
    return conv_mish_1x1_plain(convt_plain(x, wt, bt), wf, bf, wo, bo)


def convt_phase_taps(wt: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ConvTranspose2d(k4, s2, p1) weight (C_in, C_out, 4, 4) -> (4 phases,
    4 taps, C_out, C_in). Output pixel (2j+a, 2l+b) takes tap (u, v) of phase
    2a+b from input pixel (j-1+a+u, l-1+b+v) through ``wt[..., 3-a-2u,
    3-b-2v]``: with the kernel flipped, index a+2u, read as (u, a)."""
    ci, co = wt.shape[:2]
    w = wt.flip(2, 3).permute(2, 3, 1, 0)  # (ky, kx, C_out, C_in), ky = 2u + a
    w = w.reshape(2, 2, 2, 2, co, ci).permute(1, 3, 0, 2, 4, 5)  # (a, b, u, v, ...)
    return w.reshape(4, 4, co, ci).to(dtype).contiguous()


def core_wo(wo: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(cout, C, 1, 1) 1x1 weight -> (C, 4) for cout <= 4, (C, 8) above, in
    ``dtype``, zero past cout: what the conv core's hook reads, one 8-byte
    load for four output channels of an input channel."""
    cout, c = wo.shape[:2]
    out = torch.zeros(c, 4 if cout <= 4 else 8, dtype=dtype, device=wo.device)
    out[:, :cout] = wo[:, :, 0, 0].t().to(dtype)
    return out


@K.counted
def tail_fuse(x, wt, bt, wf, bf, wo, bo):
    """x: (B,C,H,W) the last up stage's output -> (B,out_dim,2H,2W).
    ``wt``/``bt``: ConvT params; ``wf``/``bf``: (C,C,3,3)/(C,) final Block
    conv; ``wo``/``bo``: (out_dim,C,1,1)/(out_dim,) final 1x1 conv. CUDA
    tensors launch the kernels (a ConvT launch and a conv + 1x1 launch),
    differentiable through the plain version."""
    args = (x, wt, bt, wf, bf, wo, bo)
    if K.on_cpu(*args):
        return tail_fuse_plain(*args)
    return region(_tail_fuse_cuda, tail_fuse_plain, *args)


def _on_core(x: torch.Tensor, cout: int) -> bool:
    """Whether the tail over ``x`` with ``cout`` outputs runs on the conv
    core (``csrc/tail_fuse_wgmma.cu``): bf16 (at C = 64, the only width the
    kernels take) and ``cout <= CORE_COUT``."""
    return x.dtype == torch.bfloat16 and cout <= CORE_COUT


def _empty(x, c, h, w):
    return torch.empty((x.shape[0], c, h, w), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)


def _launch_tile(x, wt, bt, wf, bf, wo, bo):
    """The region on ``tail_fuse.cu``'s tiled conv: float32, and bf16 with
    more than ``CORE_COUT`` outputs."""
    dt = x.dtype
    b, c, h, w = x.shape
    cout = wo.shape[0]
    y, out = _empty(x, c, 2 * h, 2 * w), _empty(x, cout, 2 * h, 2 * w)
    args = [convt_phase_taps(wt, dt), K.f32(bt, dt), K.conv_taps(wf, dt), K.f32(bf, dt),
            K.f32(wo[:, :, 0, 0], dt), K.f32(bo, dt)]
    fn = function("tail_fuse", "dgmsr_tail_fuse", 9, 4)
    rc = fn(K.dtype_code(x), x.data_ptr(), *(t.data_ptr() for t in args),
            y.data_ptr(), out.data_ptr(), cout, b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "tail_fuse")
    return out


def _launch_convt(x, wt, bt):
    """The conv core route's first launch (``convt_plain``): y, bf16 at C = 64."""
    dt = x.dtype
    b, c, h, w = x.shape
    y = _empty(x, c, 2 * h, 2 * w)
    wt_k, bt_k = convt_phase_taps(wt, dt), K.f32(bt, dt)
    fn = function("tail_fuse_wgmma", "dgmsr_convt_wgmma", 4, 4)
    rc = fn(K.dtype_code(x), x.data_ptr(), wt_k.data_ptr(), bt_k.data_ptr(), y.data_ptr(), c, b, h, w,
            K.stream_ptr())
    K.raise_on_error(rc, "tail_fuse (ConvT launch)")
    return y


def _launch_conv_mish_1x1(y, wf, bf, wo, bo):
    """The conv core route's second launch (``conv_mish_1x1_plain``) over y
    (B, 64, H, W), bf16."""
    dt = y.dtype
    b, c, h, w = y.shape
    cout = wo.shape[0]
    out = _empty(y, cout, h, w)
    args = [K.conv_taps(wf, dt), K.f32(bf, dt), core_wo(wo, dt), K.f32(bo, dt)]
    fn = function("tail_fuse_wgmma", "dgmsr_conv_mish_1x1_wgmma", 6, 5)
    rc = fn(K.dtype_code(y), y.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(), c, cout, b, h, w,
            K.stream_ptr())
    K.raise_on_error(rc, "tail_fuse (3x3 + 1x1 launch)")
    return out


def _tail_fuse_cuda(x, wt, bt, wf, bf, wo, bo):
    K.dtype_code(x)
    b, c, h, w = x.shape
    cout = wo.shape[0]
    K.check_width(c, h, w)
    K.check_act("x", x, (b, c, h, w), x.dtype)
    K.check_param("wt", wt, (c, c, 4, 4))
    K.check_param("wf", wf, (c, c, 3, 3))
    K.check_param("wo", wo, (cout, c, 1, 1))
    for name, t, n in (("bt", bt, c), ("bf", bf, c), ("bo", bo, cout)):
        K.check_param(name, t, (n,))
    core = _on_core(x, cout)
    if core:
        out = _launch_conv_mish_1x1(_launch_convt(x, wt, bt), wf, bf, wo, bo)
    else:
        out = _launch_tile(x, wt, bt, wf, bf, wo, bo)
    tail_fuse.launches += 1
    tail_fuse.launches_wgmma += core
    return out


tail_fuse.launches = 0
tail_fuse.launches_wgmma = 0
