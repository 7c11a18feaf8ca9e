"""Carry the JAX package's SD x4-upscaler params across (the inverse of the
JAX package's ``ckpt/sd_import.py``: its ``_UNET_RULES``, ``_VAE_RULES``,
``_CLIP_RULES``, ``_leaf_transform`` and ``_conv_w_inv``).

``jax_sd_params_to_state_dicts`` takes the JAX pipeline's param tree
``{"unet": ..., "vae": ..., "text_encoder": ...}`` as nested dicts of numpy
arrays and returns one ``state_dict`` per component under the published
diffusers/transformers names, which the port's SD modules load with
``strict=True``. Layouts: conv kernels HWIO -> (O, I, kh, kw), dense kernels
(I, O) -> (O, I), norm ``scale`` -> ``weight``, embedding tables as they are.
The VAE's mid attention takes the legacy names the published VAE ships
(``group_norm``, ``query``, ``key``, ``value``, ``proj_attn``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import _flatten

# (JAX module path regex -> published module name), first match wins
_UNET_RULES = [
    (r"^conv_in$", r"conv_in"),
    (r"^conv_out$", r"conv_out"),
    (r"^norm_out$", r"conv_norm_out"),
    (r"^time_embed_0$", r"time_embedding.linear_1"),
    (r"^time_embed_1$", r"time_embedding.linear_2"),
    (r"^class_embedding$", r"class_embedding"),
    (r"^down_(\d+)_res_(\d+)/(.*)$", r"down_blocks.\1.resnets.\2.\3"),
    (r"^down_(\d+)_attn_(\d+)/(.*)$", r"down_blocks.\1.attentions.\2.\3"),
    (r"^down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0.conv"),
    (r"^up_(\d+)_res_(\d+)/(.*)$", r"up_blocks.\1.resnets.\2.\3"),
    (r"^up_(\d+)_attn_(\d+)/(.*)$", r"up_blocks.\1.attentions.\2.\3"),
    (r"^up_(\d+)_upsample$", r"up_blocks.\1.upsamplers.0.conv"),
    (r"^mid_res_([01])/(.*)$", r"mid_block.resnets.\1.\2"),
    (r"^mid_attn/(.*)$", r"mid_block.attentions.0.\1"),
]

_VAE_RULES = [
    (r"^(encoder|decoder)/conv_in$", r"\1.conv_in"),
    (r"^(encoder|decoder)/conv_out$", r"\1.conv_out"),
    (r"^(encoder|decoder)/norm_out$", r"\1.conv_norm_out"),
    (r"^encoder/down_(\d+)_res_(\d+)/(.*)$", r"encoder.down_blocks.\1.resnets.\2.\3"),
    (r"^encoder/down_(\d+)_downsample$", r"encoder.down_blocks.\1.downsamplers.0.conv"),
    (r"^decoder/up_(\d+)_res_(\d+)/(.*)$", r"decoder.up_blocks.\1.resnets.\2.\3"),
    (r"^decoder/up_(\d+)_upsample$", r"decoder.up_blocks.\1.upsamplers.0.conv"),
    (r"^(encoder|decoder)/mid_res_([01])/(.*)$", r"\1.mid_block.resnets.\2.\3"),
    (r"^(encoder|decoder)/mid_attn/(.*)$", r"\1.mid_block.attentions.0.\2"),
    (r"^(quant_conv|post_quant_conv)$", r"\1"),
]

_CLIP_RULES = [
    (r"^token_embedding$", r"text_model.embeddings.token_embedding"),
    (r"^ln_final$", r"text_model.final_layer_norm"),
    (r"^block_(\d+)/attn/(q|k|v|out)_proj$", r"text_model.encoder.layers.\1.self_attn.\2_proj"),
    (r"^block_(\d+)/ln([12])$", r"text_model.encoder.layers.\1.layer_norm\2"),
    (r"^block_(\d+)/mlp_fc$", r"text_model.encoder.layers.\1.mlp.fc1"),
    (r"^block_(\d+)/mlp_proj$", r"text_model.encoder.layers.\1.mlp.fc2"),
]

# names inside a resnet / transformer block: the inverse of sd_import's
# _rewrite_unet_tail and of its legacy VAE attention renames
_UNET_TAIL = [
    (r"(^|/)block_(\d+)/", r"\1transformer_blocks.\2/"),
    (r"(attn\d)/to_out$", r"\1/to_out/0"),
    (r"ff/proj_in$", r"ff/net/0/proj"),
    (r"ff/proj_out$", r"ff/net/2"),
]
_VAE_ATTN = {"norm": "group_norm", "to_q": "query", "to_k": "key", "to_v": "value", "to_out": "proj_attn"}


def _match(rules, module: str) -> str | None:
    for pat, repl in rules:
        m = re.match(pat, module)
        if m:
            return m.expand(repl)
    return None


def _module_name(component: str, module: str) -> str | None:
    if component == "unet":
        for pat, repl in _UNET_TAIL:
            module = re.sub(pat, repl, module)
        name = _match(_UNET_RULES, module)
    elif component == "vae":
        m = re.match(r"^(encoder|decoder)/mid_attn/(\w+)$", module)
        if m and m.group(2) in _VAE_ATTN:
            module = f"{m.group(1)}/mid_attn/{_VAE_ATTN[m.group(2)]}"
        name = _match(_VAE_RULES, module)
    elif component == "text_encoder":
        name = _match(_CLIP_RULES, module)
    else:
        raise ValueError(f"unknown SD component {component!r}")
    return None if name is None else name.replace("/", ".")


def _leaf(leaf: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """JAX leaf -> (published leaf, array in the published layout)."""
    if leaf == "kernel":
        if v.ndim == 4:
            return "weight", np.transpose(v, (3, 2, 0, 1))
        if v.ndim == 2:
            return "weight", np.transpose(v, (1, 0))
    if leaf in ("scale", "embedding"):
        return "weight", v
    if leaf == "bias":
        return "bias", v
    raise KeyError(leaf)


def jax_sd_params_to_state_dict(params: Mapping, component: str) -> dict[str, torch.Tensor]:
    """One component's JAX params (nested dicts of arrays) -> the port's
    float32 ``state_dict`` under the published names. Raises on a param it
    cannot place."""
    out: dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        arr = np.asarray(v, dtype=np.float32)
        if component == "text_encoder" and path == ("position_embedding",):
            out["text_model.embeddings.position_embedding.weight"] = torch.from_numpy(np.array(arr))
            continue
        name = _module_name(component, "/".join(path[:-1]))
        if name is None:
            raise KeyError(f"cannot carry JAX {component} param {'/'.join(path)} across")
        leaf, arr = _leaf(path[-1], arr)
        out[f"{name}.{leaf}"] = torch.from_numpy(np.array(arr))  # a writable contiguous copy
    return out


def jax_sd_params_to_state_dicts(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX SD pipeline's ``params`` -> ``{component: state_dict}``."""
    return {c: jax_sd_params_to_state_dict(params[c], c) for c in ("unet", "vae", "text_encoder")}
