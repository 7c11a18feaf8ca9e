"""Bicubic and bilinear resize as two matrix products (counterpart of the JAX
package's ``ops/resize.py``).

Every resize the reference performs is a separable linear map, so each axis
is a dense ``(out_len, in_len)`` matrix built in float64 with numpy and
applied with two products. Variants (``variant=``):

- ``"matlab"``: MATLAB ``imresize`` (cubic a=-0.5, antialiased when
  shrinking, mirror boundary, weights normalised per output pixel);
- ``"torch"``: torch bicubic ``align_corners=True`` (cubic a=-0.75, no
  antialias, replicate boundary), the SRDiff serve's x4 LR upsample;
- ``"torch_half"``: torch bicubic ``align_corners=False`` (half-pixel);
- ``"pil"``: PIL BICUBIC (torchvision ``Resize``): cubic a=-0.5,
  antialiased, window clipped to the image and renormalised.

``resize`` runs on the tensor's device in float32; ``imresize`` is the
numpy float64 path of MATLAB's ``imresize`` (uint8 in, rounded uint8 out;
float in, float64 out). As the JAX package's, ``imresize`` routes the
bicubic to the port's native C++ library (``native/``) where it builds,
and keeps the matrix path as the reference and the fallback.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with free parameter ``a``."""
    x = np.abs(x.astype(np.float64))
    x2 = x * x
    x3 = x2 * x
    f = ((a + 2.0) * x3 - (a + 3.0) * x2 + 1.0) * (x <= 1.0)
    f = f + (a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a) * ((x > 1.0) & (x <= 2.0))
    return f


def _triangle(x: np.ndarray) -> np.ndarray:
    x = np.abs(x.astype(np.float64))
    return np.maximum(0.0, 1.0 - x)


def _kernel_for(method: str, variant: str):
    """(kernel function, kernel width) of ``method`` under ``variant``."""
    if method == "bilinear":
        return _triangle, 2.0
    a = -0.75 if variant in ("torch", "torch_half") else -0.5
    return functools.partial(_cubic, a=a), 4.0


def _matrix_matlab(in_len: int, out_len: int, method: str) -> np.ndarray:
    """MATLAB imresize row-weight matrix (antialias when shrinking)."""
    kernel, kernel_width = _kernel_for(method, "matlab")
    scale = out_len / in_len
    if scale < 1.0:
        width = kernel_width / scale
        h = lambda x: scale * kernel(scale * np.asarray(x, dtype=np.float64))  # noqa: E731
    else:
        width = kernel_width
        h = kernel
    # MATLAB maps output pixel x (1-indexed) to input coordinate u
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - width / 2.0)
    p = int(math.ceil(width)) + 2
    cols = left[:, None] + np.arange(p)[None, :] - 1.0  # 0-indexed taps
    w = h(u[:, None] - cols - 1.0)
    w = w / w.sum(axis=1, keepdims=True)
    # symmetric (mirror, no repeated edge) boundary
    mirror = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx = mirror[np.mod(cols.astype(np.int64), 2 * in_len)]
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_len), p), idx.reshape(-1)), w.reshape(-1))
    return mat


def _matrix_torch(in_len: int, out_len: int, method: str, align_corners: bool) -> np.ndarray:
    """torch ``F.interpolate`` row-weight matrix (no antialias, clamped edges)."""
    kernel, kernel_width = _kernel_for(method, "torch" if align_corners else "torch_half")
    taps = int(kernel_width)  # 4 for cubic, 2 for linear
    i = np.arange(out_len, dtype=np.float64)
    if align_corners:
        src = i * ((in_len - 1) / (out_len - 1)) if out_len > 1 else np.zeros_like(i)
    else:
        src = (i + 0.5) * (in_len / out_len) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    offs = np.arange(taps) - (taps // 2 - 1)  # cubic: [-1, 0, 1, 2]
    cols = base[:, None] + offs[None, :]
    w = kernel(frac[:, None] - offs[None, :].astype(np.float64))
    idx = np.clip(cols, 0, in_len - 1)
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_len), taps), idx.reshape(-1)), w.reshape(-1))
    return mat


def _matrix_pil(in_len: int, out_len: int, method: str) -> np.ndarray:
    """PIL (torchvision ``Resize``) row-weight matrix: antialiased, clipped."""
    kernel, kernel_width = _kernel_for(method, "pil")
    support = kernel_width / 2.0  # 2.0 cubic, 1.0 linear
    scale = in_len / out_len
    filterscale = max(scale, 1.0)
    supp = support * filterscale
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        center = (i + 0.5) * scale
        lo = max(int(center - supp + 0.5), 0)
        hi = min(int(center + supp + 0.5), in_len)
        j = np.arange(lo, hi, dtype=np.float64)
        w = kernel((j + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        mat[i, lo:hi] = w
    return mat


@functools.lru_cache(maxsize=256)
def resize_matrix(in_len: int, out_len: int, variant: str = "matlab", method: str = "bicubic",
                  dtype: str = "float32") -> np.ndarray:
    """Dense ``(out_len, in_len)`` resize matrix for one axis (cached; do
    not write to it)."""
    if variant == "matlab":
        m = _matrix_matlab(in_len, out_len, method)
    elif variant == "torch":
        m = _matrix_torch(in_len, out_len, method, align_corners=True)
    elif variant == "torch_half":
        m = _matrix_torch(in_len, out_len, method, align_corners=False)
    elif variant == "pil":
        m = _matrix_pil(in_len, out_len, method)
    else:
        raise ValueError(f"unknown resize variant {variant!r}")
    return m.astype(dtype)


def resize(x: torch.Tensor, out_hw: tuple[int, int], variant: str = "matlab",
           method: str = "bicubic") -> torch.Tensor:
    """Resize an NCHW tensor to ``out_hw`` with two float32 matrix products
    on its device."""
    _, _, h, w = x.shape
    mh = torch.from_numpy(resize_matrix(h, out_hw[0], variant, method)).to(x.device)
    mw = torch.from_numpy(resize_matrix(w, out_hw[1], variant, method)).to(x.device)
    y = torch.matmul(mh, x.to(torch.float32))
    return torch.matmul(y, mw.t())


def imresize(img: np.ndarray, scale: float | None = None, method: str = "bicubic",
             sizes: tuple[int, int] | None = None, use_native: bool | None = None) -> np.ndarray:
    """MATLAB ``imresize`` on an HW or HWC numpy array: ``ceil(scale * n)``
    output pixels per axis (or ``sizes``); uint8 in gives rounded, clipped
    uint8 out, float in gives float64 out.

    ``use_native`` (JAX ``ops/resize.py:182-205``): None runs the bicubic
    in the native library where it built and the matrix path elsewhere;
    False forces the matrix path; True raises where the library is
    missing."""
    if scale is not None:
        out_h = int(math.ceil(scale * img.shape[0]))
        out_w = int(math.ceil(scale * img.shape[1]))
    elif sizes is not None:
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError("either scale or sizes must be given")
    if use_native is not False and method == "bicubic":
        from dgm_img_super_resolution_tpu_torch import native

        if native.available():
            return native.matlab_resize(img, (out_h, out_w))
        if use_native:
            raise RuntimeError("native imageops requested but unavailable")
    mh = resize_matrix(img.shape[0], out_h, "matlab", method, dtype="float64")
    mw = resize_matrix(img.shape[1], out_w, "matlab", method, dtype="float64")
    x = img.astype(np.float64)
    if x.ndim == 2:
        y = mh @ x @ mw.T
    else:
        y = np.einsum("oh,hwc->owc", mh, x)
        y = np.einsum("pw,owc->opc", mw, y)
    if img.dtype == np.uint8:
        return np.around(np.clip(y, 0, 255)).astype(np.uint8)
    return y


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour NCHW upsample (the RRDB up-path)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")
