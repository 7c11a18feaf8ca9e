"""Native (C++) host-side image ops, loaded with ctypes (counterpart of the
JAX package's ``native/``, with its own copy of the source).

At first use ``src/imageops.cc`` is compiled with ``g++ -march=native``
into ``build/<cpu>/_imageops.so`` under this directory, ``<cpu>`` a digest
of the host CPU's instruction-set flags, so a checkout that moves to
another host builds for it instead of loading a library it cannot run (a
plain C interface: no pip dependency, no Python headers; ``build/`` is not
a package, so walking the package's modules does not try to import the
library). It is written under a temporary name and renamed into place, so
processes that build at once never load a partial file. Where no compiler is found or the build fails,
:func:`available` is False and ``ops/resize.imresize`` keeps its numpy
matrix path.

- ``matlab_resize(img, (oh, ow))``: MATLAB-exact bicubic resize of an HW
  or HWC array (uint8 -> uint8, float -> float64), as
  ``ops.resize.imresize``'s matrix path;
- ``u8_to_pm1(arr)`` / ``pm1_to_u8(arr)``: [0, 255] uint8 <-> [-1, 1]
  float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "imageops.cc")


def _so_path() -> str:
    """``build/<machine>-<digest of the CPU's flags in /proc/cpuinfo>/_imageops.so``."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        pass
    tag = f"{platform.machine()}-{hashlib.sha1(flags.encode()).hexdigest()[:12]}"
    return os.path.join(_HERE, "build", tag, "_imageops.so")


_lock = threading.Lock()
_lib = None
_tried = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_INT = ctypes.c_int


def _build(so: str) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
            if not _build(so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        for name, ptr in (("matlab_resize_f64", _F64P), ("matlab_resize_u8", _U8P)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, _INT, _INT, _INT, _INT, _INT, ptr, _INT]
            fn.restype = _INT
        lib.u8_to_pm1.argtypes = [_U8P, _F32P, ctypes.c_long, _INT]
        lib.u8_to_pm1.restype = None
        lib.pm1_to_u8.argtypes = [_F32P, _U8P, ctypes.c_long, _INT]
        lib.pm1_to_u8.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it at the first call)."""
    return _load() is not None


def _nthreads() -> int:
    return max(1, os.cpu_count() or 1)


def matlab_resize(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """MATLAB-exact bicubic resize of an HW or HWC array (uint8 -> uint8,
    float -> float64) in native code. Raises RuntimeError when the library
    is not available: ``ops.resize.imresize`` is the entry point that
    falls back."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native imageops unavailable")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    if x.ndim != 3:
        raise ValueError(f"matlab_resize takes an HW or HWC array, not shape {img.shape}")
    h, w, c = x.shape
    if img.dtype == np.uint8:
        src, out, fn, ptr = np.ascontiguousarray(x), np.empty((oh, ow, c), np.uint8), lib.matlab_resize_u8, _U8P
    else:
        src = np.ascontiguousarray(x, np.float64)
        out, fn, ptr = np.empty((oh, ow, c), np.float64), lib.matlab_resize_f64, _F64P
    rc = fn(src.ctypes.data_as(ptr), h, w, c, oh, ow, out.ctypes.data_as(ptr), _nthreads())
    if rc:
        raise RuntimeError(f"native resize failed (rc={rc})")
    return out[..., 0] if squeeze else out


def u8_to_pm1(arr: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(arr, np.uint8)
    if lib is None:
        return src.astype(np.float32) / 127.5 - 1.0
    out = np.empty(src.shape, np.float32)
    lib.u8_to_pm1(src.ctypes.data_as(_U8P), out.ctypes.data_as(_F32P), src.size, _nthreads())
    return out


def pm1_to_u8(arr: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(arr, np.float32)
    if lib is None:
        return np.rint(np.clip((src + 1.0) * 127.5, 0, 255)).astype(np.uint8)
    out = np.empty(src.shape, np.uint8)
    lib.pm1_to_u8(src.ctypes.data_as(_F32P), out.ctypes.data_as(_U8P), src.size, _nthreads())
    return out
