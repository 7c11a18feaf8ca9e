"""One SAME 3x3 conv C -> C with bias and optional Mish (counterpart of the
JAX package's ``ops/pallas/conv3x3.py:conv3x3_rowpack``), the Block conv
that ``DGMSR_PALLAS_CONV=1`` routes to it (``models/layers.py``).

``conv3x3`` runs the plain PyTorch version on CPU tensors and a
hand-written CUDA kernel on CUDA tensors, one launch a call, ``border``
"zero" or "reflect": bfloat16 at C = 64 (the published width) on the
warpgroup-MMA conv of ``csrc/conv3x3_wgmma.cu``, float32 and C = 32 on the
tiled ``mma.sync`` conv of ``csrc/conv3x3.cu``. ``conv3x3.launches`` counts
every launch, ``conv3x3.launches_wgmma`` those of the first kernel. Tensors
are NCHW-shaped; on the card ``x`` must be ``channels_last``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models import layers
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._autograd import region
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function

BORDERS = ("zero", "reflect")


def conv3x3_plain(x, w, b, border: str = "zero", mish: bool = False):
    """Plain composition: the padded conv with its bias in the dtype of
    ``x`` (one rounding), then Mish."""
    dt = x.dtype
    if border == "reflect":
        y = layers.reflect_conv3x3(x, w, b)
    else:
        y = F.conv2d(x, w.to(dt), b.to(dt), padding=1)
    return layers.mish(y) if mish else y


def conv3x3(x, w, b, border: str = "zero", mish: bool = False):
    """x: (B,C,H,W); w: (C,C,3,3); b: (C,). ``border``: "zero" (SAME) or
    "reflect" (ReflectionPad(1)); ``mish`` applies Mish after the bias. CUDA
    tensors launch the kernel (one launch), differentiable through the plain
    version."""
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")
    if K.on_cpu(x, w, b):
        return conv3x3_plain(x, w, b, border, mish)
    return region(_conv3x3_cuda, conv3x3_plain, x, w, b, border, mish)


def _conv3x3_cuda(x, w, b, border, mish):
    dt = x.dtype
    code = K.dtype_code(x)
    n, c, h, wd = x.shape
    if c not in (32, 64):
        raise ValueError(f"the conv3x3 kernel is instantiated for C=32 and C=64, got C={c}")
    if border == "reflect" and (h < 2 or wd < 2):
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{wd}")
    K.check_act("x", x, (n, c, h, wd), dt)
    K.check_param("w", w, (c, c, 3, 3))
    K.check_param("b", b, (c,))
    out = torch.empty((n, c, h, wd), dtype=dt, device=x.device, memory_format=torch.channels_last)
    w_k, b_k = K.conv_taps(w, dt), K.f32(b, dt)
    wgmma = dt == torch.bfloat16 and c == 64
    lib, name = ("conv3x3_wgmma", "dgmsr_conv3x3_wgmma") if wgmma else ("conv3x3", "dgmsr_conv3x3")
    fn = function(lib, name, 4, 6)
    rc = fn(code, x.data_ptr(), w_k.data_ptr(), b_k.data_ptr(), out.data_ptr(), c, int(border == "reflect"),
            int(mish), n, h, wd, K.stream_ptr())
    K.raise_on_error(rc, "conv3x3")
    conv3x3.launches += 1
    conv3x3.launches_wgmma += wgmma
    return out


conv3x3.launches = 0
conv3x3.launches_wgmma = 0
