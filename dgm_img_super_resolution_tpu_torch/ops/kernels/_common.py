"""Argument checks shared by the kernel wrappers.

A wrapper sends CPU tensors to its plain PyTorch version and launches its
kernel on CUDA tensors; everything the kernel does not take raises here, so
no CUDA tensor ever reaches a silent fallback.
"""

from __future__ import annotations

import torch

from dgm_img_super_resolution_tpu_torch.core.graphs import register_counters

C = 64  # channels of the stem, head and tail kernels
CHAIN_WIDTHS = tuple(range(32, 513, 32))  # channels the chain kernels take
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of devices or
    on a device that is neither CPU nor CUDA."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cpu"


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16 activations, got {t.dtype}")
    return _DTYPE_CODE[t.dtype]


def check_act(name: str, t: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype) -> None:
    """An NCHW-shaped activation held channels_last (NHWC memory)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: the kernel needs a channels_last contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned data")


def check_param(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_width(c: int, h: int, w: int, widths: tuple[int, ...] = (C,)) -> None:
    """``c`` one of the widths the kernel is built for; H, W >= 2."""
    if c not in widths:
        built = f"C={widths[0]}" if len(widths) == 1 else f"C in {widths[0]}..{widths[-1]} by {widths[1] - widths[0]}"
        raise ValueError(f"the CUDA kernel is built for {built}, got C={c}")
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w}")


def conv_taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C_out, C_in, 3, 3) conv weight -> (9, C_out, C_in) in ``dtype``."""
    co, ci = w.shape[:2]
    return w.permute(2, 3, 0, 1).reshape(9, co, ci).to(dtype).contiguous()


def f32(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded to the activation dtype, as float32: the values the
    plain version's convs see, in the layout the kernels read."""
    return v.to(dtype).to(torch.float32).contiguous()


def counted(fn):
    """Decorate a wrapper whose ``launches*`` attributes count its launches:
    registered with the graph cache, which adds a captured call's counts at
    every replay of it (``core/graphs.py``)."""
    return register_counters(fn)


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
