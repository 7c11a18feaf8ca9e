"""One SAME 3x3 conv C -> C with bias and optional Mish (counterpart of the
JAX package's ``ops/pallas/conv3x3.py:conv3x3_rowpack``), the Block conv
that ``DGMSR_PALLAS_CONV=1`` routes to it (``models/layers.py``).

``conv3x3`` runs the plain PyTorch version on CPU tensors and the
hand-written CUDA kernel of ``csrc/conv3x3.cu`` on CUDA tensors, for C in
{32, 64}, float32 or bfloat16, ``border`` "zero" or "reflect". Tensors are
NCHW-shaped; on the card ``x`` must be ``channels_last``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models import layers
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
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
    tensors launch the kernel (one launch)."""
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")
    if K.on_cpu(x, w, b):
        return conv3x3_plain(x, w, b, border, mish)
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
    fn = function("conv3x3", "dgmsr_conv3x3", 4, 6)
    rc = fn(code, x.data_ptr(), w_k.data_ptr(), b_k.data_ptr(), out.data_ptr(), c, int(border == "reflect"),
            int(mish), n, h, wd, K.stream_ptr())
    K.raise_on_error(rc, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
