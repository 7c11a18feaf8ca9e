"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into a build directory that git
ignores (``<repo>/build/kernels``, or ``$DGMSR_KERNEL_BUILD_DIR``). The
library's file name carries a hash of its sources and flags, so an edit to a
source rebuilds it and a warm directory is reused. All missing libraries are
compiled in parallel, one ``nvcc`` process per source. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("block_chain", "block_chain_wgmma", "head_ds_wgmma", "chain_wide", "tail_fuse", "tail_fuse_wgmma",
           "flash_attention", "conv3x3", "conv3x3_wgmma", "group_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    env = os.environ.get("DGMSR_KERNEL_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; return
    the library paths. Raises with nvcc's output if a build fails. The
    compiler's resource report (``-Xptxas -v``) is kept beside each library
    as ``<library>.log``."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, t in todo.items():
        tmp = t.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        t = todo[name]
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        Path(f"{t}.log").write_text(log)
        os.replace(tmp, t)
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return _libs[name]


def function(lib: str, fn: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """The C function ``int fn(int dtype, void* x n_ptrs, int x n_ints, float
    x n_floats, void* stream)`` of ``csrc/<lib>.cu``, declared once. Pointers
    and the stream are ``c_void_p``: an ``int`` argtype would cut them to 32
    bits."""
    if fn not in _fns:
        f = getattr(load_library(lib), fn)
        f.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        )
        f.restype = ctypes.c_int
        _fns[fn] = f
    return _fns[fn]
