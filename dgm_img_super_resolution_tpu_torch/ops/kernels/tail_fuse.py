"""The UNet tail region (counterpart of the JAX package's
``ops/pallas/tail_fuse.py``): the last Upsample's ConvTranspose(k4, s2, p1),
the final Block (reflect 3x3 conv + Mish) and the final 1x1 conv.

``tail_fuse`` runs the plain PyTorch version on CPU tensors and the
hand-written CUDA kernel of ``csrc/tail_fuse.cu`` on CUDA tensors. Weights
are in PyTorch's layouts: ``wt`` is a ``ConvTranspose2d`` weight (C_in,
C_out, 4, 4), not flipped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import mish, reflect_conv3x3
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._autograd import region
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function


def tail_fuse_plain(x, wt, bt, wf, bf, wo, bo):
    """Plain composition (``tail_reference``): ConvT + bias -> reflect 3x3 +
    bias + Mish -> 1x1 + bias, in the activation dtype."""
    dt = x.dtype
    y = F.conv_transpose2d(x, wt.to(dt), bt.to(dt), stride=2, padding=1)
    y = mish(reflect_conv3x3(y, wf, bf).float()).to(dt)
    return F.conv2d(y, wo.to(dt), bo.to(dt))


def convt_phase_taps(wt: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ConvTranspose2d(k4, s2, p1) weight (C_in, C_out, 4, 4) -> (4 phases,
    4 taps, C_out, C_in). Output pixel (2j+a, 2l+b) takes tap (u, v) of phase
    2a+b from input pixel (j-1+a+u, l-1+b+v) through ``wt[..., 3-a-2u,
    3-b-2v]``: with the kernel flipped, index a+2u, read as (u, a)."""
    ci, co = wt.shape[:2]
    w = wt.flip(2, 3).permute(2, 3, 1, 0)  # (ky, kx, C_out, C_in), ky = 2u + a
    w = w.reshape(2, 2, 2, 2, co, ci).permute(1, 3, 0, 2, 4, 5)  # (a, b, u, v, ...)
    return w.reshape(4, 4, co, ci).to(dtype).contiguous()


def tail_fuse(x, wt, bt, wf, bf, wo, bo):
    """x: (B,C,H,W) the last up stage's output -> (B,out_dim,2H,2W).
    ``wt``/``bt``: ConvT params; ``wf``/``bf``: (C,C,3,3)/(C,) final Block
    conv; ``wo``/``bo``: (out_dim,C,1,1)/(out_dim,) final 1x1 conv. CUDA
    tensors launch the kernel (a ConvT launch and a conv + 1x1 launch),
    differentiable through the plain version."""
    args = (x, wt, bt, wf, bf, wo, bo)
    if K.on_cpu(*args):
        return tail_fuse_plain(*args)
    return region(_tail_fuse_cuda, tail_fuse_plain, *args)


def _tail_fuse_cuda(x, wt, bt, wf, bf, wo, bo):
    dt = x.dtype
    code = K.dtype_code(x)
    b, c, h, w = x.shape
    cout = wo.shape[0]
    K.check_width(c, h, w)
    K.check_act("x", x, (b, c, h, w), dt)
    K.check_param("wt", wt, (c, c, 4, 4))
    K.check_param("wf", wf, (c, c, 3, 3))
    K.check_param("wo", wo, (cout, c, 1, 1))
    for name, t, n in (("bt", bt, c), ("bf", bf, c), ("bo", bo, cout)):
        K.check_param(name, t, (n,))
    y = torch.empty((b, c, 2 * h, 2 * w), dtype=dt, device=x.device,
                    memory_format=torch.channels_last)
    out = torch.empty((b, cout, 2 * h, 2 * w), dtype=dt, device=x.device,
                      memory_format=torch.channels_last)
    args = [convt_phase_taps(wt, dt), K.f32(bt, dt), K.conv_taps(wf, dt), K.f32(bf, dt),
            K.f32(wo[:, :, 0, 0], dt), K.f32(bo, dt)]
    fn = function("tail_fuse", "dgmsr_tail_fuse", 9, 4)
    rc = fn(code, x.data_ptr(), *(t.data_ptr() for t in args),
            y.data_ptr(), out.data_ptr(), cout, b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "tail_fuse")
    tail_fuse.launches += 1
    return out


tail_fuse.launches = 0
