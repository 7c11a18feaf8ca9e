"""GroupNorm + affine + optional SiLU (counterpart of the JAX package's
``ops/pallas/groupnorm.py:fused_group_norm``).

As in the JAX package, nothing calls it yet: the SD modules normalise with
``nn.GroupNorm``. ``fused_group_norm`` runs the plain PyTorch version on CPU
tensors and the hand-written CUDA kernel of ``csrc/group_norm.cu`` on CUDA
tensors. It takes (N,C,H,W)-shaped tensors held NCHW-contiguous or
channels_last and returns the same layout. The statistics follow the JAX
kernel: sums of x and x^2 in float32 and ``var = E[x^2] - mean^2``
(``F.group_norm`` uses Welford's update instead).
"""

from __future__ import annotations

import torch

from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function

ACTS = (None, "silu")


def _channels_last(x: torch.Tensor) -> bool:
    """Held channels_last, and not also NCHW-contiguous (as a 1x1 image is)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def fused_group_norm_plain(x, scale, bias, groups: int = 32, eps: float = 1e-5, act: str | None = None):
    """Plain composition of the JAX kernel's arithmetic, in float32, cast
    back to the dtype of ``x``."""
    n, c = x.shape[:2]
    xg = x.float().reshape(n, groups, -1)
    cnt = xg.shape[-1]
    mean = xg.sum(-1, keepdim=True) / cnt
    var = (xg * xg).sum(-1, keepdim=True) / cnt - mean * mean
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    fmt = torch.channels_last if _channels_last(x) else torch.contiguous_format
    return y.to(x.dtype).contiguous(memory_format=fmt)


def fused_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5, act: str | None = None):
    """x: (N,C,H,W); scale, bias: (C,); ``act``: None or "silu". CUDA
    tensors launch the kernel (one call of three launches: statistics split
    over many blocks per group, finalize, normalize)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    if K.on_cpu(x, scale, bias):
        return fused_group_norm_plain(x, scale, bias, groups, eps, act)
    code = K.dtype_code(x)
    cl = _channels_last(x)
    if not (cl or x.is_contiguous()):
        raise ValueError("the group_norm kernel needs an NCHW-contiguous or a channels_last tensor")
    K.check_param("scale", scale, (c,))
    K.check_param("bias", bias, (c,))
    hw, cg = h * w, c // groups
    v = 16 // x.element_size()
    vec = x.data_ptr() % 16 == 0 and (cg if cl else hw) % v == 0
    unit = v if vec else 1
    nsm = torch.cuda.get_device_properties(x.device).multi_processor_count
    # about 4 blocks per SM for the statistics, each with >= 1024 units of work
    splits = max(1, min(-(-4 * nsm // (n * groups)), -(-(cg * hw // unit) // 1024)))
    apply_blocks = max(1, min(-(-(n * c * hw // unit) // 256), 16 * nsm))
    out = torch.empty_like(x)
    scratch = torch.empty(n * groups * (2 * splits + 2), dtype=torch.float32, device=x.device)
    sc, bi = scale.float().contiguous(), bias.float().contiguous()
    fn = function("group_norm", "dgmsr_group_norm", 5, 9, 1)
    rc = fn(code, x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, c, hw, groups, splits, int(cl), int(vec), int(act == "silu"), apply_blocks, eps, K.stream_ptr())
    K.raise_on_error(rc, "fused_group_norm")
    fused_group_norm.launches += 1
    return out


fused_group_norm.launches = 0
