"""The SD x4-upscaler slice as a whole: the port's
``StableDiffusionUpscalePipeline`` against the JAX package's, on the CPU.

Both pipelines run the tiny configs with the same weights: random
published-schema state dicts go to JAX through its importer
(``ckpt/sd_import.convert_component``) and come back to the port through
``ckpt/sd_params.py``. The port's noise hook is fed the JAX draws:
``rng_prep, rng_steps = split(rng)``, ``rng_lat, rng_aug = split(rng_prep)``,
the initial latents ``normal(rng_lat)``, the LR augmentation noise
``normal(rng_aug)`` and, per step when eta > 0, ``normal(fold_in(rng_steps,
t))``. Tolerance: 1e-3 absolute on the NHWC [0, 1] output (float32; the
v-prediction DDIM update and guidance 9 amplify the UNet's sum-order
differences before the VAE decode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ckpt.sd_import import convert_component
from dgm_img_super_resolution_tpu.models.sd.clip import CLIPTextEncoder as JaxCLIP
from dgm_img_super_resolution_tpu.models.sd.clip import SimpleTokenizer as JaxTokenizer
from dgm_img_super_resolution_tpu.models.sd.pipeline import StableDiffusionUpscalePipeline as JaxPipeline
from dgm_img_super_resolution_tpu.models.sd.unet import UNet2DCondition as JaxUNet
from dgm_img_super_resolution_tpu.models.sd.vae import AutoencoderKL as JaxVAE
from dgm_img_super_resolution_tpu_torch.ckpt import sd_inventory as inv
from dgm_img_super_resolution_tpu_torch.ckpt.sd_params import jax_sd_params_to_state_dicts
from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY, random_published_state_dict, sd_jax_noise

RUNS = {  # the keyword arguments of both calls, and the callback's stride
    "ddim3_eta0_cfg": (dict(num_inference_steps=3, guidance_scale=9.0), 1),
    "ddpm2_cfg": (dict(num_inference_steps=2, guidance_scale=9.0, sampler="ddpm"), 2),
}


@pytest.fixture(scope="module")
def pipelines():
    params = {
        c: convert_component(random_published_state_dict(shapes(cfg), seed), c)[0]
        for c, cfg, shapes, seed in (
            ("unet", UNET_TINY, inv.unet_state_dict_shapes, 11),
            ("vae", VAE_TINY, inv.vae_state_dict_shapes, 12),
            ("text_encoder", CLIP_TINY, inv.text_encoder_state_dict_shapes, 13),
        )
    }
    jpipe = JaxPipeline(
        unet=JaxUNet.from_config(UNET_TINY, dtype=jnp.float32),
        vae=JaxVAE(block_out_channels=(32, 64), layers_per_block=2, scaling_factor=VAE_TINY["scaling_factor"],
                   dtype=jnp.float32),
        text_encoder=JaxCLIP(vocab_size=1024, width=64, layers=3, heads=4, hidden_act="gelu", dtype=jnp.float32),
        tokenizer=JaxTokenizer(vocab_size=1024), params=params, dtype=jnp.float32,
    )
    tpipe = StableDiffusionUpscalePipeline(
        jax_sd_params_to_state_dicts(jax.tree_util.tree_map(np.asarray, params)),
        unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY, dtype=torch.float32, device="cpu",
    )
    return jpipe, tpipe


@pytest.mark.parametrize("run", sorted(RUNS))
def test_pipeline_matches_jax(pipelines, run):
    jpipe, tpipe = pipelines
    kw, every = RUNS[run]
    kw = dict(kw, noise_level=5)
    imgs = np.random.default_rng(14).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(21)
    steps = kw["num_inference_steps"]
    ts = (np.arange(steps) * (1000 // steps))[::-1] + 1
    want = jpipe(["a cat", "a dog"], imgs, rng=key, **kw)
    seen = []
    got = tpipe(["a cat", "a dog"], imgs, noise=sd_jax_noise(key, 2, 8, 8, ts), callback_steps=every,
                callback=lambda i, t, x: seen.append((i, t, tuple(x.shape))), **kw)
    # every `every`-th step and the last, as the JAX pipeline's segments
    assert seen == [(i, int(t), (2, 4, 8, 8)) for i, t in enumerate(ts) if (i + 1) % every == 0 or i == steps - 1]
    assert got.shape == want.shape == (2, 16, 16, 3)  # the tiny VAE halves once
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
