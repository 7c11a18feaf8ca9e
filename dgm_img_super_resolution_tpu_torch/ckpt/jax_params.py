"""Carry the JAX package's SRDiff params across (counterpart of the JAX
package's ``ckpt/torch_import.py:32-158`` and ``:206``, run the other way).

``jax_params_to_state_dict`` takes the JAX param tree ``{"denoise_fn": ...,
"rrdb": ...}`` as nested dicts of numpy arrays and returns the port's
``state_dict`` under the reference checkpoint's names
(``denoise_fn.downs.0.0.block1.block.1.weight``,
``rrdb.RRDB_trunk.0.RDB1.conv1.weight``, ...), which
``GaussianDiffusion.load_state_dict(strict=True)`` accepts. Layouts:

- conv kernels are HWIO (kh, kw, I, O) -> PyTorch (O, I, kh, kw);
- ConvTranspose kernels are HWIO and stored spatially *pre-flipped* ->
  PyTorch ``ConvTranspose2d`` (I, O, kh, kw), flipped back;
- dense kernels (I, O) -> ``Linear`` (O, I).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _conv(v: np.ndarray) -> np.ndarray:
    return np.transpose(v, (3, 2, 0, 1))


def _convt(v: np.ndarray) -> np.ndarray:
    return np.transpose(v, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _dense(v: np.ndarray) -> np.ndarray:
    return np.transpose(v, (1, 0))


_RESNET_INNER = {
    "mlp": ("mlp.1", _dense),
    "block1/conv": ("block1.block.1", _conv),
    "block2/conv": ("block2.block.1", _conv),
    "res_conv": ("res_conv", _conv),
}


def _unet_module(path: str):
    """Flax module path under ``denoise_fn`` -> (torch module name, kernel
    transform), or None."""
    fixed = {
        "cond_proj": ("cond_proj", _convt),
        "mlp_0": ("mlp.0", _dense),
        "mlp_1": ("mlp.2", _dense),
        "up_proj": ("up_proj.1", _conv),
        "final_block/conv": ("final_conv.0.block.1", _conv),
        "final_conv": ("final_conv.1", _conv),
    }
    if path in fixed:
        return fixed[path]
    m = re.match(r"^(down|up)_(\d+)_(res[12]|downsample|upsample)/(.*)$", path)
    if m:
        kind = "downs" if m.group(1) == "down" else "ups"
        i, part, inner = m.group(2), m.group(3), m.group(4)
        if part == "downsample" and inner == "conv":
            return f"downs.{i}.2.conv.1", _conv
        if part == "upsample" and inner == "conv":
            return f"ups.{i}.2.conv.0", _convt
        if part in ("res1", "res2") and inner in _RESNET_INNER:
            name, tr = _RESNET_INNER[inner]
            return f"{kind}.{i}.{int(part[-1]) - 1}.{name}", tr
        return None
    m = re.match(r"^(mid_block[12])/(.*)$", path)
    if m and m.group(2) in _RESNET_INNER:
        name, tr = _RESNET_INNER[m.group(2)]
        return f"{m.group(1)}.{name}", tr
    return None


def _rrdb_module(path: str):
    m = re.match(r"^RRDB_trunk_(\d+)/(RDB\d)/(conv\d)$", path)
    if m:
        return f"RRDB_trunk.{m.group(1)}.{m.group(2)}.{m.group(3)}", _conv
    if re.match(r"^(conv_first|trunk_conv|upconv[123]|HRconv|conv_last)$", path):
        return path, _conv
    return None


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX SRDiff params (nested dicts of arrays) -> the port's float32
    ``state_dict``. Raises on a param it cannot place."""
    out: dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        root, module, leaf = path[0], "/".join(path[1:-1]), path[-1]
        lookup = {"denoise_fn": _unet_module, "rrdb": _rrdb_module}.get(root)
        found = lookup(module) if lookup else None
        if found is None or leaf not in ("kernel", "bias"):
            raise KeyError(f"cannot carry JAX param {'/'.join(path)} across")
        name, tr = found
        arr = np.asarray(v, dtype=np.float32)
        if leaf == "kernel":
            key, arr = f"{root}.{name}.weight", tr(arr)
        else:
            key = f"{root}.{name}.bias"
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
