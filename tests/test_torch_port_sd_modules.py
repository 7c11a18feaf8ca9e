"""The port's SD x4-upscaler modules against the JAX package's, on the CPU.

One random state dict under the published diffusers/transformers names
(enumerated by the port's ``ckpt/sd_inventory.py``) goes into the port's
modules with ``load_state_dict(strict=True)`` and into the JAX modules
through the JAX importer (``ckpt/sd_import.convert_component``); inputs come
from numpy seeds. Tolerance: float32, max |port - JAX| at most 1e-4 of
max |JAX| (sums in another order through a few chained layers).

Where the JAX module reaches the Pallas flash-attention kernel (a
self-attention of at least 1024 tokens) it runs in interpret mode, as the
JAX package's own tests run it on the CPU; the port's wrapper takes its
plain version on CPU tensors.
"""

import gzip
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ckpt.sd_import import convert_component
from dgm_img_super_resolution_tpu.models.sd import attention as jattn
from dgm_img_super_resolution_tpu.models.sd import clip as jclip
from dgm_img_super_resolution_tpu.models.sd import unet as junet
from dgm_img_super_resolution_tpu.models.sd.vae import AutoencoderKL as JaxVAE
from dgm_img_super_resolution_tpu.ops.pallas.attention import flash_attention as jax_flash
from dgm_img_super_resolution_tpu_torch.ckpt import sd_inventory as inv
from dgm_img_super_resolution_tpu_torch.ckpt.sd_params import jax_sd_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.models.sd import attention as tattn
from dgm_img_super_resolution_tpu_torch.models.sd import unet as tunet
from dgm_img_super_resolution_tpu_torch.models.sd.clip import CLIPTextEncoder, SimpleTokenizer
from dgm_img_super_resolution_tpu_torch.models.sd.vae import AutoencoderKL
from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

from test_clip_tokenizer import CORPUS, MERGES  # the tokenizer fixture's merge table and prompts
from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY, random_published_state_dict

TOL = 1e-4


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _torch_sd(sd: dict, prefix: str = "") -> dict:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items() if k.startswith(prefix)}


def _unet_part(prefix: str, seed: int):
    """Random weights of one UNet submodule of the tiny config: (the port's
    state dict under names relative to it, the JAX tree)."""
    shapes = {k: v for k, v in inv.unet_state_dict_shapes(UNET_TINY).items() if k.startswith(prefix + ".")}
    sd = random_published_state_dict(shapes, seed)
    tree, unused = convert_component(sd, "unet")
    assert not unused and len(tree) == 1
    return _torch_sd(sd, prefix + "."), next(iter(tree.values()))


@pytest.mark.parametrize("b,l,h,d", [(2, 1024, 2, 64), (1, 256, 3, 32)])
def test_flash_plain_version_matches_jax_kernel(b, l, h, d):
    g = np.random.default_rng(l + d)
    q, k, v = (g.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    before = fa.flash_attention.launches
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert fa.flash_attention.launches == before  # CPU tensors take the plain version
    assert got.shape == (b, l, h, d) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("prefix,hw,only_cross", [
    ("mid_block.attentions.0", 32, False),       # 1024-token self-attention: the flash kernel in JAX
    ("down_blocks.1.attentions.0", 8, True),     # attn1 attends to the text states
])
def test_transformer2d_matches_jax(prefix, hw, only_cross):
    sd, tree = _unet_part(prefix, seed=3)
    heads, cross = UNET_TINY["attention_head_dim"], UNET_TINY["cross_attention_dim"]
    port = tattn.Transformer2D(64, heads, cross, only_cross)
    port.load_state_dict(sd, strict=True)
    ref = jattn.Transformer2D(heads, 64 // heads, use_flash=True, only_cross_attention=only_cross)
    g = np.random.default_rng(hw)
    x = g.standard_normal((2, hw, hw, 64)).astype(np.float32)
    ctx = g.standard_normal((2, 7, cross)).astype(np.float32)
    want = ref.apply({"params": tree}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(ctx))
    _close(_nhwc(got), want)


@pytest.mark.parametrize("prefix,cin,cout", [
    ("down_blocks.1.resnets.0", 32, 64),  # width changes: 1x1 conv_shortcut
    ("mid_block.resnets.0", 64, 64),
])
def test_sd_resblock_matches_jax(prefix, cin, cout):
    sd, tree = _unet_part(prefix, seed=4)
    port = tunet.ResnetBlock2D(cin, cout, 4 * UNET_TINY["block_out_channels"][0])
    port.load_state_dict(sd, strict=True)
    g = np.random.default_rng(cin)
    x = g.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = g.standard_normal((2, 128)).astype(np.float32)
    want = junet.SDResBlock(cout).apply({"params": tree}, jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(temb))
    _close(_nhwc(got), want)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 251, 999], np.int32)
    want = junet.timestep_embedding(jnp.asarray(t), 32)
    _close(tunet.timestep_embedding(torch.from_numpy(t), 32), want)


def test_unet_matches_jax_at_latent_64():
    """At latent 64x64 the tiny UNet's mid self-attention has 1024 tokens, so
    JAX runs the Pallas flash kernel (interpret mode) there."""
    sd = random_published_state_dict(inv.unet_state_dict_shapes(UNET_TINY), seed=5)
    port = tunet.UNet2DCondition(UNET_TINY)
    port.load_state_dict(_torch_sd(sd), strict=True)
    tree, _ = convert_component(sd, "unet")
    ref = junet.UNet2DCondition.from_config(UNET_TINY)
    g = np.random.default_rng(6)
    x = g.standard_normal((2, 64, 64, 7)).astype(np.float32)
    t, nl = np.array([951, 1], np.int32), np.array([3, 16], np.int32)
    ctx = g.standard_normal((2, 7, 64)).astype(np.float32)
    want = ref.apply({"params": tree}, *(jnp.asarray(a) for a in (x, t, ctx, nl)))
    before = fa.flash_attention.launches
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), torch.from_numpy(nl).long())
    assert fa.flash_attention.launches == before
    assert got.shape == (2, 4, 64, 64)
    _close(_nhwc(got), want)


@pytest.fixture(scope="module")
def vae_pair():
    sd = random_published_state_dict(inv.vae_state_dict_shapes(VAE_TINY), seed=7)
    port = AutoencoderKL(VAE_TINY)
    port.load_state_dict(_torch_sd(sd), strict=True)
    tree, _ = convert_component(sd, "vae")
    ref = JaxVAE(block_out_channels=(32, 64), layers_per_block=2, latent_channels=4,
                 scaling_factor=VAE_TINY["scaling_factor"])
    return port, ref, tree


def test_vae_decode_matches_jax(vae_pair):
    port, ref, tree = vae_pair
    z = np.random.default_rng(8).standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.1
    want = ref.apply({"params": tree}, jnp.asarray(z), method=ref.decode)
    with torch.no_grad():
        got = port.decode(_nchw(z))
    assert got.shape == (2, 3, 16, 16)
    _close(_nhwc(got), want)


def test_vae_encode_matches_jax(vae_pair):
    """The posterior mean, scaled (not on the serving path; the encoder is
    ported so that the published state dict loads whole)."""
    port, ref, tree = vae_pair
    img = np.random.default_rng(9).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = ref.apply({"params": tree}, jnp.asarray(img), method=ref.encode)
    with torch.no_grad():
        got = port.encode(_nchw(img))
    assert got.shape == (2, 4, 8, 8)
    _close(_nhwc(got), want)


def test_clip_encoder_and_tokenizer_match_jax():
    sd = random_published_state_dict(inv.text_encoder_state_dict_shapes(CLIP_TINY), seed=9)
    port = CLIPTextEncoder(CLIP_TINY)
    port.load_state_dict(_torch_sd(sd), strict=True)
    tree, _ = convert_component(sd, "text_encoder")
    ref = jclip.CLIPTextEncoder(vocab_size=1024, width=64, layers=3, heads=4, hidden_act="gelu")
    prompts = ["a photo of a cat", "", "low resolution, blurry!"]
    ids = SimpleTokenizer(vocab_size=1024)(prompts)
    np.testing.assert_array_equal(ids, jclip.SimpleTokenizer(vocab_size=1024)(prompts))
    want = ref.apply({"params": tree}, jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    _close(got, want)


def test_tokenizer_bpe_loaders_match_jax(tmp_path):
    """Both BPE file formats give the JAX tokenizer's ids on its corpus."""
    base = list(jclip.bytes_to_unicode().values())
    vocab = base + [v + "</w>" for v in base] + ["".join(m) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tmp_path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}), encoding="utf-8")
    lines = "\n".join(" ".join(m) for m in MERGES)
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + lines + "\n", encoding="utf-8")
    with gzip.open(tmp_path / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("header\n" + lines + "\n")
    hf = dict(vocab_json=str(tmp_path / "vocab.json"), merges_txt=str(tmp_path / "merges.txt"))
    want = jclip.SimpleTokenizer(**hf)(CORPUS)
    np.testing.assert_array_equal(SimpleTokenizer(**hf)(CORPUS), want)
    np.testing.assert_array_equal(SimpleTokenizer(bpe_path=str(tmp_path / "bpe.txt.gz"))(CORPUS), want)


@pytest.mark.parametrize("component", ["unet", "vae", "text_encoder"])
def test_weight_round_trip(component):
    """Published-schema weights -> the JAX importer -> the port's carry-over
    give back the same state dict, which the port's module loads strictly."""
    cfg, shapes, build = {
        "unet": (UNET_TINY, inv.unet_state_dict_shapes, tunet.UNet2DCondition),
        "vae": (VAE_TINY, inv.vae_state_dict_shapes, AutoencoderKL),
        "text_encoder": (CLIP_TINY, inv.text_encoder_state_dict_shapes, CLIPTextEncoder),
    }[component]
    sd = random_published_state_dict(shapes(cfg), seed=10)
    tree, _ = convert_component(sd, component)
    back = jax_sd_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), component)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    build(cfg).load_state_dict(back, strict=True)
