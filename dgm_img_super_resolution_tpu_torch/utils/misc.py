"""Tensor and host utilities (counterpart of the JAX package's
``utils/misc.py``; the reference's helper layer, ``srdiff/model.py:63-75,
1315-1402``).


:func:`reduce_metrics` is the JAX package's mean over the mesh's ``dp``
axis (``lax.pmean``): an ``all_reduce`` over the ranks of the process
group, the identity without one (``parallel/mesh.py``). Host <-> device
moves take an explicit device; randomness comes from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import datetime
import os
import random
from typing import Any, Iterable, Iterator

import numpy as np
import torch


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def reduce_metrics(metrics: Any, axis_name: str = "dp", mesh=None) -> Any:
    """The mean over the ranks of the ``dp`` axis of a tree of tensors and
    python numbers, each leaf returned as its kind (numbers as floats): the
    identity in a world of 1. Every rank calls it with a tree of the same
    structure; one ``all_reduce`` carries every leaf."""
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import all_reduce_mean, default_mesh

    mesh = default_mesh(mesh)
    if mesh.world == 1:
        return metrics
    if axis_name not in mesh.shape:
        raise NotImplementedError(f"only the dp axis is ported, not {axis_name!r}")
    number = (float, int, np.floating, np.integer)
    leaves: list = []
    _map(lambda v: leaves.append(v) if isinstance(v, (torch.Tensor, *number)) else None, metrics)
    if not leaves:
        return metrics
    flat = torch.cat([torch.as_tensor(v, dtype=torch.float64).detach().reshape(-1).to(mesh.device)
                      for v in leaves])
    all_reduce_mean([flat], mesh)
    vals, off = flat.cpu(), 0

    def put(v):
        nonlocal off
        if isinstance(v, torch.Tensor):
            out = vals[off: off + v.numel()].view(v.shape).to(v.device, v.dtype)
            off += v.numel()
            return out
        if isinstance(v, number):
            off += 1
            return float(vals[off - 1])
        return v

    return _map(put, metrics)


def tensors_to_scalars(tensors: Any) -> Any:
    """Tree of one-element tensors / arrays -> python floats (reference
    ``model.py:1327-1340``)."""
    def one(v):
        if isinstance(v, torch.Tensor) and v.numel() == 1:
            return float(v.detach().item())
        if isinstance(v, np.ndarray) and v.size == 1:
            return float(v.reshape(()))
        return v

    return _map(one, tensors)


def tensors_to_np(tensors: Any) -> Any:
    """Tree of tensors -> numpy (reference ``model.py:1343-1369``)."""
    return _map(lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v, tensors)


def to_host(tree: Any) -> Any:
    """Device -> host (reference ``move_to_cpu``, ``model.py:1372-1380``)."""
    return _map(lambda v: v.detach().cpu() if isinstance(v, torch.Tensor) else v, tree)


def to_device(tree: Any, device: str | torch.device) -> Any:
    """Host -> ``device`` (reference ``move_to_cuda``, ``model.py:1383-1402``):
    numpy arrays and tensors; to the card through pinned memory, without
    waiting for the copy."""
    device = torch.device(device)

    def one(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if not isinstance(v, torch.Tensor):
            return v
        if device.type == "cuda" and v.device.type == "cpu":
            return v.pin_memory().to(device, non_blocking=True)
        return v.to(device)

    return _map(one, tree)


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed the host RNGs and torch's, and return a ``torch.Generator``
    seeded with ``seed`` (the working version of the reference's
    ``set_seed``, wgan-gp.ipynb cell 5)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def make_run_dir(base: str, name: str = "run") -> str:
    """Timestamped run directory (reference wgan-gp.ipynb cell 5)."""
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(base, f"{name}_{stamp}")
    os.makedirs(path, exist_ok=True)
    return path


def cycle(dl: Iterable) -> Iterator:
    """Endless iterator over a dataloader (reference ``model.py:63-66``)."""
    while True:
        for data in dl:
            yield data


def num_to_groups(num: int, divisor: int) -> list[int]:
    """Split ``num`` into ``divisor``-sized groups + remainder (reference
    ``model.py:69-75``)."""
    groups, remainder = divmod(num, divisor)
    return [divisor] * groups + ([remainder] if remainder > 0 else [])


def plot_img(img, path: str) -> None:
    """Save an HWC [-1,1] or [0,1] float (or uint8) image to ``path``
    (reference ``plot_img``, ``model.py:1458-1461``, without matplotlib)."""
    from PIL import Image

    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (arr + 1.0) * 127.5 if arr.min() < -0.01 else arr * 255.0  # [-1, 1] or [0, 1]
        arr = np.round(np.clip(arr, 0, 255)).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)
