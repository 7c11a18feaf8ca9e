"""The port's loader of a local diffusers checkout of the SD x4-upscaler
(``ckpt/sd_import.py:load_sd_x4_pipeline``), on the CPU.

A diffusers-layout directory is written from ``random_published_state_dict``
at the tiny SD configs, in safetensors and in ``.bin``, with the keys the
JAX importer drops (``text_model.embeddings.position_ids``) and, in one of
them, the newer VAE attention names. The loaded pipeline holds the written
weights exactly and serves bit for bit as the pipeline built in memory from
them; the checkout's scheduler configs are taken; with the tokenizer's
HuggingFace files present it tokenizes as the JAX package's
``SimpleTokenizer`` on the same files.
"""

import json
import re

import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.ckpt.sd_import import map_key
from dgm_img_super_resolution_tpu.models.sd.clip import SimpleTokenizer as JaxTokenizer
from dgm_img_super_resolution_tpu.models.sd.clip import bytes_to_unicode
from dgm_img_super_resolution_tpu_torch.ckpt import sd_import, sd_inventory as inv
from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

from test_clip_tokenizer import CORPUS, MERGES
from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY, random_published_state_dict

CONFIGS = dict(unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY)
SHAPES = {"unet": inv.unet_state_dict_shapes(UNET_TINY), "vae": inv.vae_state_dict_shapes(VAE_TINY),
          "text_encoder": inv.text_encoder_state_dict_shapes(CLIP_TINY)}
FILES = {"safetensors": {"unet": "diffusion_pytorch_model.safetensors", "vae": "diffusion_pytorch_model.safetensors",
                         "text_encoder": "model.safetensors"},
         "bin": {"unet": "diffusion_pytorch_model.bin", "vae": "diffusion_pytorch_model.bin",
                 "text_encoder": "pytorch_model.bin"}}
SCHEDULERS = {"safetensors": {"prediction_type": "epsilon", "beta_end": 0.015},
              "bin": {"prediction_type": "v_prediction", "beta_end": 0.011, "set_alpha_to_one": True}}
NEW_VAE_ATTN = [(r"\.query\.", ".to_q."), (r"\.key\.", ".to_k."), (r"\.value\.", ".to_v."),
                (r"\.proj_attn\.", ".to_out.0.")]


def _write_vocab(d):
    base = list(bytes_to_unicode().values())
    vocab = base + [v + "</w>" for v in base] + ["".join(m) for m in MERGES] + ["<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n",
                                  encoding="utf-8")


@pytest.fixture(scope="module")
def checkouts(tmp_path_factory):
    """{format: (directory, the state dicts as written, in float32)}."""
    weights = {c: {k: torch.from_numpy(v) for k, v in random_published_state_dict(s, seed=i).items()}
               for i, (c, s) in enumerate(SHAPES.items())}
    out = {}
    for fmt, names in FILES.items():
        d = tmp_path_factory.mktemp(f"x4_{fmt}")
        for comp, name in names.items():
            (d / comp).mkdir()
            sd = dict(weights[comp])
            if comp == "text_encoder":
                sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
            if comp == "vae" and fmt == "bin":  # a newer export's attention names
                renamed = {}
                for k, v in sd.items():
                    if ".mid_block.attentions.0." in k:
                        for pat, repl in NEW_VAE_ATTN:
                            k = re.sub(pat, repl, k)
                    renamed[k] = v
                sd = renamed
            if fmt == "safetensors":
                from safetensors.torch import save_file

                save_file(sd, str(d / comp / name))
            else:
                torch.save(sd, d / comp / name)
        for sub, cfg in (("scheduler", SCHEDULERS[fmt]), ("low_res_scheduler", {"beta_end": 0.03})):
            (d / sub).mkdir()
            (d / sub / "scheduler_config.json").write_text(json.dumps(cfg))
        if fmt == "bin":
            (d / "tokenizer").mkdir()
            _write_vocab(d / "tokenizer")
        out[fmt] = (d, weights)
    return out


@pytest.mark.parametrize("fmt", sorted(FILES))
def test_loader_holds_the_files_and_serves_as_in_memory(fmt, checkouts, capsys):
    d, weights = checkouts[fmt]
    pipe = sd_import.load_sd_x4_pipeline(str(d), dtype=torch.float32, device="cpu", **CONFIGS)
    assert "text_encoder: dropped 1 keys ['text_model.embeddings.position_ids']" in capsys.readouterr().out
    for comp, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.text_encoder)):
        sd = module.state_dict()
        assert set(sd) == set(weights[comp]), comp
        for k, v in weights[comp].items():
            assert torch.equal(sd[k], v), (comp, k)
    sc = SCHEDULERS[fmt]
    assert pipe.prediction_type == sc["prediction_type"]
    ref = StableDiffusionUpscalePipeline(weights, dtype=torch.float32, device="cpu", scheduler_config=sc,
                                         low_res_scheduler_config={"beta_end": 0.03}, tokenizer=pipe.tokenizer,
                                         **CONFIGS)
    np.testing.assert_array_equal(pipe.schedule.betas, ref.schedule.betas)
    np.testing.assert_array_equal(pipe.low_res_schedule.betas, ref.low_res_schedule.betas)
    assert pipe.final_alpha_cumprod == ref.final_alpha_cumprod
    assert ref.final_alpha_cumprod == (1.0 if sc.get("set_alpha_to_one") else ref.schedule.alphas_cumprod[0])
    img = np.random.default_rng(2).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    kw = dict(num_inference_steps=2, guidance_scale=3.0, noise_level=10)  # < the tiny UNet's 17 classes
    got = pipe("a photo of a cat", img, generator=torch.Generator().manual_seed(3), **kw)
    want = ref("a photo of a cat", img, generator=torch.Generator().manual_seed(3), **kw)
    assert got.shape == (1, 16, 16, 3)  # the tiny VAE upsamples x2
    np.testing.assert_array_equal(got, want)


def test_tokenizer_files_tokenize_as_jax(checkouts):
    d, _ = checkouts["bin"]
    pipe = sd_import.load_sd_x4_pipeline(str(d), dtype=torch.float32, device="cpu", **CONFIGS)
    want = JaxTokenizer(vocab_json=str(d / "tokenizer" / "vocab.json"), merges_txt=str(d / "tokenizer" / "merges.txt"))
    np.testing.assert_array_equal(pipe.tokenizer(CORPUS), want(CORPUS))
    # without tokenizer files: the hash-bucket fallback of the pipeline's own
    d2, _ = checkouts["safetensors"]
    pipe2 = sd_import.load_sd_x4_pipeline(str(d2), dtype=torch.float32, device="cpu", **CONFIGS)
    fallback = StableDiffusionUpscalePipeline(None, dtype=torch.float32, device="cpu", **CONFIGS).tokenizer
    np.testing.assert_array_equal(pipe2.tokenizer(CORPUS), fallback(CORPUS))


def test_dropped_keys_are_the_jax_importers_and_a_missing_weight_raises(checkouts, tmp_path):
    for comp, shapes in SHAPES.items():
        for key in list(shapes) + ["text_model.embeddings.position_ids", "unet_extra.weight", "vae.extra"]:
            kept = bool(sd_import._KEPT[comp].match(key))
            assert kept == (map_key(comp, key) is not None), (comp, key)
    d, weights = checkouts["safetensors"]
    import shutil

    shutil.copytree(d, tmp_path / "x4")
    sd = {k: v for k, v in weights["unet"].items() if k != "conv_out.bias"}
    from safetensors.torch import save_file

    save_file(sd, str(tmp_path / "x4" / "unet" / FILES["safetensors"]["unet"]))
    with pytest.raises(RuntimeError, match="Missing key"):
        sd_import.load_sd_x4_pipeline(str(tmp_path / "x4"), dtype=torch.float32, device="cpu", **CONFIGS)
    with pytest.raises(FileNotFoundError):
        sd_import._read_state_dict(str(tmp_path))
