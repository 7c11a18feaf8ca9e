"""The SD x4-upscaler's options in the port against the JAX package, on the
CPU: encoder propagation (``enc_interval``), negative prompts, and the
scheduler-config overrides with an eps-predicting model.

The tiny published-schema configs and the weights are those of
``tests/test_torch_port_sd_pipeline.py``: random state dicts go to JAX
through its importer and come back through ``ckpt/sd_params.py``, and the
port's noise hook is fed the JAX draws. Tolerance: that file's, 1e-3
absolute on the NHWC [0, 1] output. The UNet's encode then decode is its
full forward bit for bit.
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

# the eps model's scheduler: another spacing offset, the terminal alpha 1;
# and LR noise augmentation on other betas
EPS_SCHEDULER = dict(prediction_type="epsilon", steps_offset=0, set_alpha_to_one=True)
LOW_RES_SCHEDULER = dict(beta_end=0.03)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The params both ways, and one JAX pipeline per scheduler override:
    its jitted pieces compile once for the tests that share it."""
    jp = {
        c: convert_component(random_published_state_dict(shapes(cfg), seed), c)[0]
        for c, cfg, shapes, seed in (
            ("unet", UNET_TINY, inv.unet_state_dict_shapes, 21),
            ("vae", VAE_TINY, inv.vae_state_dict_shapes, 22),
            ("text_encoder", CLIP_TINY, inv.text_encoder_state_dict_shapes, 23),
        )
    }
    return jp, jax_sd_params_to_state_dicts(jax.tree_util.tree_map(np.asarray, jp)), {}


def _pipes(params, **sched):
    jp, tp, jax_pipes = params
    key = repr(sorted(sched.items()))
    if key not in jax_pipes:
        jax_pipes[key] = JaxPipeline(
            unet=JaxUNet.from_config(UNET_TINY, dtype=jnp.float32),
            vae=JaxVAE(block_out_channels=(32, 64), layers_per_block=2, scaling_factor=VAE_TINY["scaling_factor"],
                       dtype=jnp.float32),
            text_encoder=JaxCLIP(vocab_size=1024, width=64, layers=3, heads=4, hidden_act="gelu",
                                 dtype=jnp.float32),
            tokenizer=JaxTokenizer(vocab_size=1024), params=jp, dtype=jnp.float32, **sched,
        )
    jpipe = jax_pipes[key]
    tpipe = StableDiffusionUpscalePipeline(tp, unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY,
                                           dtype=torch.float32, device="cpu", **sched)
    return jpipe, tpipe


# (name, scheduler overrides, keyword arguments of both calls)
RUNS = [
    ("enc_interval2", {}, dict(num_inference_steps=3, enc_interval=2)),
    ("negative_prompt", {}, dict(num_inference_steps=2, negative_prompt="blurry")),
    ("negative_prompts", {}, dict(num_inference_steps=2, negative_prompt=["blurry", "noisy, dark"])),
    ("eps_scheduler", dict(scheduler_config=EPS_SCHEDULER, low_res_scheduler_config=LOW_RES_SCHEDULER),
     dict(num_inference_steps=2, sampler="ddpm")),
]


@pytest.mark.parametrize("name,sched,kw", RUNS, ids=[r[0] for r in RUNS])
def test_pipeline_option_matches_jax(params, name, sched, kw):
    jpipe, tpipe = _pipes(params, **sched)
    kw = dict(kw, guidance_scale=9.0, noise_level=5)
    imgs = np.random.default_rng(14).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(31)
    steps = kw["num_inference_steps"]
    ts = (np.arange(steps) * (1000 // steps))[::-1] + tpipe.steps_offset
    want = jpipe(["a cat", "a dog"], imgs, rng=key, **kw)
    got = tpipe(["a cat", "a dog"], imgs, noise=sd_jax_noise(key, 2, 8, 8, ts), **kw)
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if name == "enc_interval2":  # an approximation of the exact chain
        exact = tpipe(["a cat", "a dog"], imgs, noise=sd_jax_noise(key, 2, 8, 8, ts), **dict(kw, enc_interval=1))
        assert 0 < np.abs(got - exact).max() < 0.5
    if name.startswith("negative"):  # the negative prompt reaches the unconditional half
        plain = tpipe(["a cat", "a dog"], imgs, noise=sd_jax_noise(key, 2, 8, 8, ts), **dict(kw, negative_prompt=None))
        assert np.abs(got - plain).max() > 0


def test_unet_encode_decode_is_the_full_forward(params):
    _, tpipe = _pipes(params)
    unet = tpipe.unet
    g = torch.Generator().manual_seed(3)
    x, ctx = torch.randn(2, 7, 8, 8, generator=g), torch.randn(2, 5, 64, generator=g)
    t, nl = torch.tensor([3, 7]), torch.tensor([2, 2])
    with torch.no_grad():
        full = unet(x, t, ctx, nl)
        enc = unet(x, t, ctx, nl, mode="encode")
        split = unet(None, t, ctx, nl, mode="decode", enc_feats=enc)
    torch.testing.assert_close(split, full, rtol=0, atol=0)
    assert len(enc[0]) == 1 + 2 * 2 + 1  # conv_in, two resnets a level, one downsample


def test_callback_runs_the_exact_chain_and_options_raise_as_jax(params):
    """With a callback every step runs exactly, whatever ``enc_interval``
    (as JAX's progress path); an unknown ``prediction_type`` raises where
    JAX raises, at the update; a negative prompt list must match the
    prompts."""
    _, tpipe = _pipes(params)
    imgs = np.random.default_rng(2).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
    run = lambda **kw: tpipe("a cat", imgs, num_inference_steps=2, noise_level=5,  # noqa: E731
                             generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(run(callback=lambda *a: None, enc_interval=2), run())
    with pytest.raises(ValueError, match="negative prompts"):
        run(negative_prompt=["a", "b"])
    _, odd = _pipes(params, scheduler_config=dict(prediction_type="sample"))
    with pytest.raises(NotImplementedError, match="sample"):
        odd("a cat", imgs, num_inference_steps=1, noise_level=5)
