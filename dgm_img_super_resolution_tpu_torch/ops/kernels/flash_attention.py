"""Non-causal flash attention (counterpart of the JAX package's
``ops/pallas/attention.py:flash_attention``).

``flash_attention`` runs the plain PyTorch version on CPU tensors and the
hand-written CUDA kernel of ``csrc/flash_attention.cu`` on CUDA tensors.
Both take and return the JAX layout, (B, L, H, D). Unlike the JAX function,
neither needs L to divide by a block size: the kernel masks a ragged last
tile of queries and keys.
"""

from __future__ import annotations

import torch

from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function

HEAD_DIMS = (64, 128)  # head widths the kernel is instantiated for


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The function the kernel computes, in one block: scores in float32
    scaled by D^-1/2 after the product, ``p = exp(s - max s)`` in float32, the
    normaliser summed from that float32 ``p``, the PV product over ``p``
    rounded to v's dtype with a float32 sum, and ``out / l`` cast to q's
    dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # noqa: E741
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Lq, H, D); k, v: (B, Lk, H, D) -> (B, Lq, H, D). CUDA tensors
    launch the kernel (float32 or bfloat16, D in ``HEAD_DIMS``) and raise on
    anything it does not take."""
    if K.on_cpu(q, k, v):
        return flash_attention_reference(q, k, v)
    code = K.dtype_code(q)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width D={d} has no kernel instantiation {HEAD_DIMS}")
    for name, t, shape in (("q", q, (b, lq, h, d)), ("k", k, (b, lk, h, d)), ("v", v, (b, lk, h, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}, expected {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    fn = function("flash_attention", "dgmsr_flash_attention", 4, 5)
    rc = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, lq, lk, d, K.stream_ptr())
    K.raise_on_error(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
