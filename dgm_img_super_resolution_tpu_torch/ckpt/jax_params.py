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
- dense kernels (I, O) -> ``Linear`` (O, I);
- GroupNorm ``scale`` -> ``weight`` (a Block's norm is its ``block.2``);
- the mid attention's gate ``mid_attn_g`` -> ``mid_attn.fn.g`` and its
  1x1 convs ``mid_attn/{to_qkv,to_out}`` -> ``mid_attn.fn.fn.*`` (the
  reference's ``Residual(Rezero(LinearAttention))``).

``jax_conv_params_to_state_dict`` carries the metrics' conv stacks across,
the JAX package's LPIPS (``metrics/lpips.py``) and VGG19
(``metrics/perceptual.py``) Flax trees, whose port modules keep the Flax
module names; ``jax_npz_to_state_dict`` reads such a tree from the JAX
package's ``.npz`` weight files ('/'-joined keys).

``jax_module_params_to_state_dict`` carries the educational models across
(the AE and VAE, the GANs with their BatchNorm statistics, the DDPM UNet,
``MultiheadAttention``): their port modules keep the flax module names, so
the port module a leaf lands in decides its layout.
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


def _id(v: np.ndarray) -> np.ndarray:
    return v


_RESNET_INNER = {
    "mlp": ("mlp.1", _dense),
    "block1/conv": ("block1.block.1", _conv),
    "block1/norm": ("block1.block.2", _id),
    "block2/conv": ("block2.block.1", _conv),
    "block2/norm": ("block2.block.2", _id),
    "res_conv": ("res_conv", _conv),
}
# JAX leaf -> PyTorch parameter name
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _unet_module(path: str):
    """Flax module path under ``denoise_fn`` -> (torch module name, kernel
    transform), or None."""
    fixed = {
        "cond_proj": ("cond_proj", _convt),
        "mlp_0": ("mlp.0", _dense),
        "mlp_1": ("mlp.2", _dense),
        "up_proj": ("up_proj.1", _conv),
        "final_block/conv": ("final_conv.0.block.1", _conv),
        "final_block/norm": ("final_conv.0.block.2", _id),
        "final_conv": ("final_conv.1", _conv),
        "mid_attn/to_qkv": ("mid_attn.fn.fn.to_qkv", _conv),
        "mid_attn/to_out": ("mid_attn.fn.fn.to_out", _conv),
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
        arr = np.asarray(v, dtype=np.float32)
        if path == ("denoise_fn", "mid_attn_g"):
            out["denoise_fn.mid_attn.fn.g"] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
        root, module, leaf = path[0], "/".join(path[1:-1]), path[-1]
        lookup = {"denoise_fn": _unet_module, "rrdb": _rrdb_module}.get(root)
        found = lookup(module) if lookup else None
        weight = "scale" if found is not None and found[1] is _id else "kernel"  # a norm's, or a kernel
        if found is None or leaf not in (weight, "bias"):
            raise KeyError(f"cannot carry JAX param {'/'.join(path)} across")
        name, tr = found
        if leaf != "bias":
            arr = tr(arr)
        # a copy: through ascontiguousarray a flipped axis of size 1 keeps its negative stride
        out[f"{root}.{name}.{_LEAVES[leaf]}"] = torch.from_numpy(np.array(arr, order="C"))
    return out


def jax_conv_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """A Flax tree of convs (LPIPS, VGG19; nested dicts of arrays, with or
    without its ``params`` root) -> the port's float32 ``state_dict`` under
    the same module names: HWIO kernels -> (O, I, kh, kw) weights, biases
    as they are."""
    out: dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        if path[0] == "params":
            path = path[1:]
        arr = np.asarray(v, dtype=np.float32)
        if path[-1] == "kernel" and arr.ndim == 4:
            arr, leaf = _conv(arr), "weight"
        elif path[-1] == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"cannot carry JAX param {'/'.join(path)} across")
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def jax_npz_to_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The JAX package's ``.npz`` of a metric's Flax tree ('/'-joined keys)
    -> the port's ``state_dict``."""
    with np.load(path) as raw:
        tree: dict = {}
        for key in raw.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = raw[key]
    return jax_conv_params_to_state_dict(tree)


# Flax module paths of the educational models -> the port's module names, where they differ: the
# ResnetBlocks and Blocks of the DDPM UNet keep the SRDiff UNet's torch layout (``block1.block.1`` ...)
_EDU_RENAMES = [
    (r"(^|/)(block[12])/conv$", r"\1\2/block/1"),
    (r"(^|/)(block[12])/norm$", r"\1\2/block/2"),
    (r"(_res[12])/mlp$", r"\1/mlp/1"),
    (r"(_downsample)/conv$", r"\1/conv/1"),
    (r"(_upsample)/conv$", r"\1/conv/0"),
    (r"^final_res/conv$", r"final_res/block/1"),
    (r"^final_res/norm$", r"final_res/block/2"),
]
# MultiheadAttention's flax leaves -> (the port's parameter name, transposed)
_MHA_LEAVES = {"in_proj_kernel": ("in_proj_weight", True), "in_proj_bias": ("in_proj_bias", False),
               "out_proj_kernel": ("out_proj.weight", True), "out_proj_bias": ("out_proj.bias", False),
               "bias_k": ("bias_k", False), "bias_v": ("bias_v", False)}


def jax_module_params_to_state_dict(model: torch.nn.Module, params: Mapping,
                                    batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """A JAX educational model's ``params`` (and BatchNorm ``batch_stats``),
    nested dicts of numpy arrays -> the float32 ``state_dict`` of the port's
    ``model`` (``models/{autoencoder,gan,ddpm_unet}.py``, or a
    ``MultiheadAttention``), whose modules carry the flax names. Each leaf's
    layout follows the port module it lands in: ``Linear`` kernels (I, O)
    -> (O, I), ``Conv2d`` HWIO -> (O, I, kh, kw), ``ConvTranspose2d`` (the
    JAX ``ConvTranspose2dTorch``, pre-flipped HWIO) -> (I, O, kh, kw)
    flipped back, norm ``scale`` -> ``weight``, BatchNorm ``mean`` / ``var``
    -> ``running_mean`` / ``running_var``, ``MultiheadAttention``'s packed
    kernels transposed. Raises on a leaf it cannot place."""
    from dgm_img_super_resolution_tpu_torch.models.layers import BatchNorm, MultiheadAttention

    out: dict[str, torch.Tensor] = {}
    trees = [(p, v, False) for p, v in _flatten(params)]
    trees += [(p, v, True) for p, v in _flatten(batch_stats or {})]
    for path, v, is_stat in trees:
        if path[0] in ("params", "batch_stats"):
            path = path[1:]
        arr = np.asarray(v, dtype=np.float32)
        module, leaf = "/".join(path[:-1]), path[-1]
        for pat, repl in _EDU_RENAMES:
            module = re.sub(pat, repl, module)
        name = module.replace("/", ".")
        try:
            mod = model.get_submodule(name)
        except AttributeError:
            raise KeyError(f"cannot carry JAX param {'/'.join(path)} across: no module {name!r}") from None
        prefix = f"{name}." if name else ""
        if isinstance(mod, MultiheadAttention) and leaf in _MHA_LEAVES:
            target, transpose = _MHA_LEAVES[leaf]
            arr = _dense(arr) if transpose else arr
        elif is_stat and isinstance(mod, BatchNorm) and leaf in ("mean", "var"):
            target = f"running_{leaf}"
        elif leaf == "bias":
            target = "bias"
        elif leaf == "scale" and isinstance(mod, (torch.nn.GroupNorm, BatchNorm)):
            target = "weight"
        elif leaf == "kernel" and isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            target = "weight"
            arr = {torch.nn.Linear: _dense, torch.nn.Conv2d: _conv, torch.nn.ConvTranspose2d: _convt}[type(mod)](arr)
        else:
            raise KeyError(f"cannot carry JAX param {'/'.join(path)} across to {type(mod).__name__}")
        # a copy: through ascontiguousarray a flipped axis of size 1 keeps its negative stride
        out[prefix + target] = torch.from_numpy(np.array(arr, order="C"))
    return out
