"""Loader of a local diffusers checkout of the SD x4-upscaler (counterpart of
the JAX package's ``ckpt/sd_import.py:205-271``).

A ``stabilityai/stable-diffusion-x4-upscaler`` directory holds ``unet/``,
``vae/`` and ``text_encoder/`` state dicts (``.safetensors`` or ``.bin``),
``scheduler/`` and ``low_res_scheduler/`` configs, and ``tokenizer/``
files. The port's SD modules carry the published names, so loading is
reading the files, dropping what the JAX importer drops (keys outside its
rule tables, such as ``text_model.embeddings.position_ids``; reported),
renaming the newer VAE attention names to the legacy ones the published
VAE and the port use, and a strict ``load_state_dict``: a missing
parameter raises. Float16 files are upcast to float32 on load; the
pipeline then casts to its dtype.
"""

from __future__ import annotations

import json
import os
import re

import torch

# the published names the JAX importer's rule tables take (its _UNET_RULES,
# _VAE_RULES, _CLIP_RULES); any other key is dropped
_KEPT = {
    "unet": re.compile(
        r"^(conv_in|conv_out|conv_norm_out|time_embedding\.linear_[12]|class_embedding\.linear_[12])\."
        r"|^class_embedding\.weight$"
        r"|^(down|up)_blocks\.\d+\.(resnets|attentions)\.\d+\."
        r"|^down_blocks\.\d+\.downsamplers\.0\.conv\.|^up_blocks\.\d+\.upsamplers\.0\.conv\."
        r"|^mid_block\.(resnets\.[01]|attentions\.0)\."),
    "vae": re.compile(
        r"^(encoder|decoder)\.(conv_in|conv_out|conv_norm_out)\."
        r"|^encoder\.down_blocks\.\d+\.(resnets\.\d+|downsamplers\.0\.conv)\."
        r"|^decoder\.up_blocks\.\d+\.(resnets\.\d+|upsamplers\.0\.conv)\."
        r"|^(encoder|decoder)\.mid_block\.(resnets\.[01]|attentions\.0)\."
        r"|^(quant_conv|post_quant_conv)\."),
    "text_encoder": re.compile(
        r"^text_model\.embeddings\.(token_embedding|position_embedding)\.weight$"
        r"|^text_model\.final_layer_norm\."
        r"|^text_model\.encoder\.layers\.\d+\.(self_attn\.(q|k|v|out)_proj|layer_norm[12]|mlp\.fc[12])\."),
}
# newer diffusers VAE attention names -> the legacy ones
_VAE_ATTN = [(r"\.to_q\.", ".query."), (r"\.to_k\.", ".key."), (r"\.to_v\.", ".value."),
             (r"\.to_out\.0\.", ".proj_attn.")]


def _read_state_dict(component_dir: str) -> dict[str, torch.Tensor]:
    """The first state-dict file of a component directory, as tensors on
    the CPU in their stored dtype."""
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin"):
        path = os.path.join(component_dir, name)
        if os.path.exists(path):
            if path.endswith(".safetensors"):
                from safetensors.torch import load_file

                return load_file(path)
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no state dict in {component_dir}")


def _read_json(path: str) -> dict | None:
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    return None


def convert_component(state_dict: dict, component: str) -> tuple[dict[str, torch.Tensor], list[str]]:
    """One component's published state dict -> (the port's float32 state
    dict, the keys dropped)."""
    out, dropped = {}, []
    for key, v in state_dict.items():
        if not _KEPT[component].match(key):
            dropped.append(key)
            continue
        if component == "vae" and ".mid_block.attentions.0." in key:
            for pat, repl in _VAE_ATTN:
                key = re.sub(pat, repl, key)
        out[key] = v.to(torch.float32)
    return out, dropped


def load_sd_x4_pipeline(ckpt_dir: str, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = None, **model_configs):
    """A ``StableDiffusionUpscalePipeline`` from a local diffusers checkout.
    The checkout's ``scheduler/`` and ``low_res_scheduler/`` configs
    override the published defaults; its ``tokenizer/`` files
    (``vocab.json`` + ``merges.txt``, or the OpenAI
    ``bpe_simple_vocab_16e6.txt.gz``) give the exact CLIP tokenizer.
    ``model_configs`` (``unet_config``, ``vae_config``, ``text_config``)
    default to the published configs."""
    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_TEXT_CONFIG
    from dgm_img_super_resolution_tpu_torch.models.sd.clip import SimpleTokenizer
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    params = {}
    for component in ("unet", "vae", "text_encoder"):
        sd, dropped = convert_component(_read_state_dict(os.path.join(ckpt_dir, component)), component)
        if dropped:
            print(f"| sd import: {component}: dropped {len(dropped)} keys {dropped[:3]}")
        params[component] = sd
    text_config = model_configs.get("text_config", X4_TEXT_CONFIG)
    tok_dir = os.path.join(ckpt_dir, "tokenizer")
    bpe = os.path.join(tok_dir, "bpe_simple_vocab_16e6.txt.gz")
    tokenizer = SimpleTokenizer(bpe_path=bpe if os.path.exists(bpe) else None,
                                vocab_size=text_config["vocab_size"],
                                max_len=text_config["max_position_embeddings"],
                                vocab_json=os.path.join(tok_dir, "vocab.json"),
                                merges_txt=os.path.join(tok_dir, "merges.txt"))
    return StableDiffusionUpscalePipeline(
        params, tokenizer=tokenizer, dtype=dtype, device=device,
        scheduler_config=_read_json(os.path.join(ckpt_dir, "scheduler", "scheduler_config.json")),
        low_res_scheduler_config=_read_json(os.path.join(ckpt_dir, "low_res_scheduler", "scheduler_config.json")),
        **model_configs)
