"""The SD UNet's ``use_flash`` switch (JAX ``models/sd/unet.py:101``,
``attention.py:45,62,89,122``) on the CPU, each case with the flag off and
on, against the JAX module built with the same flag and the same weights
(carried across by the JAX importer, as ``test_torch_port_sd_modules.py``).

- ``Transformer2D`` at 1024 tokens, where the flag decides the route of the
  self-attention, and the tiny ``UNet2DCondition`` at latent 64, whose mid
  block attends over 1024 tokens. Where JAX takes its Pallas kernel it runs
  in interpret mode; the port's CPU tensors take the kernel's plain version.
- The port's ``flash_attention`` is patched to count its calls and to raise
  when the flag is off: off, it is never called; on, as often as the block
  layout says (``chip_smoke.sd_flash_per_call``).
- ``StableDiffusionUpscalePipeline(use_flash=...)`` builds its UNet so, and
  a tiny serve at LR 64 is the same either way within the SD pipeline's
  tolerance (``test_torch_port_sd_pipeline.py``: 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.ckpt.sd_import import convert_component
from dgm_img_super_resolution_tpu.models.sd import attention as jattn
from dgm_img_super_resolution_tpu.models.sd import unet as junet
from dgm_img_super_resolution_tpu_torch.ckpt import sd_inventory as inv
from dgm_img_super_resolution_tpu_torch.models.sd import attention as tattn
from dgm_img_super_resolution_tpu_torch.models.sd import unet as tunet
from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

from chip_smoke import sd_flash_per_call
from test_torch_port_sd_modules import _close, _nchw, _nhwc, _torch_sd, _unet_part
from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY, random_published_state_dict

PIPE_TOL = 1e-3  # the SD pipeline's bound on the NHWC [0, 1] output


@pytest.fixture
def flash_calls(monkeypatch):
    """Patch the port's flash entry: count the calls; with ``allowed`` False
    a call raises."""
    state = {"calls": 0, "allowed": True}
    plain = tattn.flash_attention

    def spy(q, k, v):
        if not state["allowed"]:
            raise AssertionError("flash_attention called with use_flash off")
        state["calls"] += 1
        return plain(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    return state


@pytest.mark.parametrize("use_flash", [False, True])
def test_transformer2d_follows_the_switch(flash_calls, use_flash):
    """The mid block's Transformer2D at 32x32 = 1024 tokens: attn1 is
    self-attention (the kernel's route with the flag on), attn2 attends to
    7 text tokens (plain either way)."""
    sd, tree = _unet_part("mid_block.attentions.0", seed=3)
    heads, cross = UNET_TINY["attention_head_dim"], UNET_TINY["cross_attention_dim"]
    port = tattn.Transformer2D(64, heads, cross, use_flash=use_flash)
    port.load_state_dict(sd, strict=True)
    ref = jattn.Transformer2D(heads, 64 // heads, use_flash=use_flash)
    g = np.random.default_rng(32)
    x = g.standard_normal((2, 32, 32, 64)).astype(np.float32)
    ctx = g.standard_normal((2, 7, cross)).astype(np.float32)
    want = ref.apply({"params": tree}, jnp.asarray(x), jnp.asarray(ctx))
    flash_calls["allowed"] = use_flash
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(ctx))
    assert flash_calls["calls"] == int(use_flash)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("use_flash", [False, True])
def test_unet_follows_the_switch(flash_calls, use_flash):
    sd = random_published_state_dict(inv.unet_state_dict_shapes(UNET_TINY), seed=5)
    port = tunet.UNet2DCondition(UNET_TINY, use_flash=use_flash)
    port.load_state_dict(_torch_sd(sd), strict=True)
    tree, _ = convert_component(sd, "unet")
    ref = junet.UNet2DCondition.from_config(UNET_TINY, use_flash=use_flash)
    assert ref.use_flash == use_flash
    g = np.random.default_rng(6)
    x = g.standard_normal((2, 64, 64, 7)).astype(np.float32)
    t, nl = np.array([951, 1], np.int32), np.array([3, 16], np.int32)
    ctx = g.standard_normal((2, 7, 64)).astype(np.float32)
    want = ref.apply({"params": tree}, *(jnp.asarray(a) for a in (x, t, ctx, nl)))
    flash_calls["allowed"] = use_flash
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), torch.from_numpy(nl).long())
    per_call = sum(sd_flash_per_call(port, 64))
    assert per_call == (1 if use_flash else 0)  # the mid block's self-attention alone
    assert flash_calls["calls"] == per_call
    _close(_nhwc(got), want)


def test_unet_defaults_to_jaxs_routing():
    """JAX's defaults: the UNet on, its submodules off."""
    assert junet.UNet2DCondition.use_flash is True and jattn.Transformer2D.use_flash is False
    unet = tunet.UNet2DCondition(UNET_TINY)
    assert {m.use_flash for m in unet.modules() if isinstance(m, tattn.Attention)} == {True}
    assert not tattn.Transformer2D(64, 2, 64).transformer_blocks[0].attn1.use_flash


def test_pipeline_builds_its_unet_with_the_switch(flash_calls):
    cfg = dict(unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY, dtype=torch.float32,
               device="cpu")
    img = np.random.default_rng(8).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    outs = {}
    for use_flash in (False, True):
        pipe = StableDiffusionUpscalePipeline(**cfg, use_flash=use_flash)
        assert {m.use_flash for m in pipe.unet.modules() if isinstance(m, tattn.Attention)} == {use_flash}
        flash_calls.update(calls=0, allowed=use_flash)
        outs[use_flash] = pipe("a cat", img, num_inference_steps=2, noise_level=5,
                              generator=torch.Generator().manual_seed(4))
        assert flash_calls["calls"] == 2 * sum(sd_flash_per_call(pipe.unet, 64))  # one UNet call a step
    assert outs[True].shape == (1, 128, 128, 3)  # the tiny VAE decodes x2
    np.testing.assert_allclose(outs[False], outs[True], rtol=0, atol=PIPE_TOL)
