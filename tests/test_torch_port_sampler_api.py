"""Repairs of two inputs the JAX package takes and the port used to refuse,
held against JAX on the CPU.

1. The SRDiff sampler's API (``diffusion/gaussian.py``, JAX ``:310-397``,
   ``:559-573``): ``sample(..., save_intermediate=True)`` with the stacked
   per-step images and x0 predictions; the public one-step ``p_sample``
   (with and without ``noise_pred``, ``clip_denoised``, a raw or projected
   condition); ``sample_prepare``'s ``shape=`` and the non-residual start
   from the noised LR upsample; ``ddim_sample``'s ``shape=`` (two draws for
   a batch-1 condition); the ``clip_input=`` override of ``res2img``
   / ``img2res``. A tiny SRDiff stack (hidden 8, mults 1|2, T = 4, HR 16),
   the JAX params carried across, JAX's key stream fed to the port's hook.
   Bound 1e-4 absolute, as ``tests/test_torch_port_pipeline.py`` (float32
   through the UNet each step, the x0 step scaling eps by up to
   sqrt((1 - a_t) / a_t)); the main path's output is the same bit for bit
   with and without ``save_intermediate``.
2. The SD UNet's timestep-style class embedding when ``num_class_embeds`` is
   None (JAX ``models/sd/unet.py:159-171``): the tiny SD UNet with class
   labels against JAX at the SD modules' bound (1e-4 of the output's
   largest magnitude, ``tests/test_torch_port_sd_modules.py``), the params
   carried by ``ckpt/sd_params.py`` from JAX's ``class_embed_0/1``; the
   published config keeps its 1000-row table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.models.sd import unet as junet
from dgm_img_super_resolution_tpu_torch.ckpt import sd_inventory as inv
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.ckpt.sd_params import jax_sd_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff
from dgm_img_super_resolution_tpu_torch.models.sd import unet as tunet

from torch_port_helpers import UNET_TINY, jax_noise, jit_quick, random_jax_params

TOL, SD_TOL = 1e-4, 1e-4
CFG = dict(hidden_size=8, unet_dim_mults="1|2", rrdb_num_block=2, rrdb_num_feat=8, timesteps=4,
           compute_dtype="float32")


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(*range(t.ndim - 3), t.ndim - 2, t.ndim - 1, t.ndim - 3).numpy()


def stack(cfg, seed=1):
    jhp = JHparams(cfg)
    d, params = random_jax_params(jhp, seed)
    m = build_srdiff(Hparams(cfg))
    m.load_state_dict(jax_params_to_state_dict(params), strict=False)
    return d, params, m


def inputs(seed=2):
    g = np.random.default_rng(seed)
    lr = g.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    up = g.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    return lr, up


@pytest.fixture(scope="module")
def tiny():
    return stack(CFG)


def test_sample_save_intermediate_matches_jax(tiny):
    d, params, m = tiny
    lr, up = inputs()
    key = jax.random.PRNGKey(7)
    img, rrdb_out, (imgs, x0s) = jit_quick(lambda p, a, b, k: d.sample(p, a, b, k, save_intermediate=True),
                                           params, lr, up, key)(params, lr, up, key)
    noise = jax_noise(key, (2, 16, 16, 3), range(4))
    with torch.no_grad():
        t_img, t_rrdb, (t_imgs, t_x0s) = m.sample(nchw(lr), nchw(up), noise=noise, save_intermediate=True)
        main, _ = m.sample(nchw(lr), nchw(up), noise=noise)
    assert tuple(t_imgs.shape) == tuple(t_x0s.shape) == (4, 2, 3, 16, 16)
    assert torch.equal(main, t_img) and torch.equal(t_imgs[-1], t_img)
    for got, want in ((t_img, img), (t_rrdb, rrdb_out), (t_imgs, imgs), (t_x0s, x0s)):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["unet_raw_cond", "unet_projected", "noise_pred_unclipped"])
def test_p_sample_matches_jax(tiny, mode):
    d, params, m = tiny
    lr, up = inputs(3)
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 1], np.int32)
    key = jax.random.PRNGKey(5)
    step_noise = nchw(jax.random.normal(key, x.shape))  # the draw p_sample takes from its key
    _, jcond = d.rrdb_cond(params, jnp.asarray(lr), jnp.asarray(up))
    with torch.no_grad():
        _, tcond = m.rrdb_cond(nchw(lr), nchw(up))
    kw, tkw = {}, {}
    if mode == "unet_projected":
        jcond = d._project_cond(params, jcond, jnp.asarray(up))
        tcond = m.denoise_fn.project(tcond, nchw(up))
        kw = tkw = dict(cond_projected=True)
    elif mode == "noise_pred_unclipped":
        eps = (g.standard_normal(x.shape) * 3).astype(np.float32)  # large enough that the x0 clip would bite
        kw = dict(noise_pred=jnp.asarray(eps), clip_denoised=False)
        tkw = dict(noise_pred=nchw(eps), clip_denoised=False)
    want_x, want_x0 = d.p_sample(params, jnp.asarray(x), jnp.asarray(t), jcond, jnp.asarray(up), key, **kw)
    with torch.no_grad():
        got_x, got_x0 = m.p_sample(nchw(x), torch.from_numpy(t).long(), tcond, nchw(up), step_noise, **tkw)
    np.testing.assert_allclose(nhwc(got_x), np.asarray(want_x), rtol=0, atol=TOL)
    np.testing.assert_allclose(nhwc(got_x0), np.asarray(want_x0), rtol=0, atol=TOL)
    if mode == "noise_pred_unclipped":
        assert float(got_x0.abs().max()) > 1.0


def test_sample_prepare_shape_and_nonres_start():
    cfg = dict(CFG, res=False)
    d, params, m = stack(cfg, seed=6)
    lr, up = inputs(7)
    key = jax.random.PRNGKey(9)
    x, _, _, _ = d.sample_prepare(params, jnp.asarray(lr), jnp.asarray(up), key, shape=(2, 16, 16, 3))
    x_t, _ = jax_noise(key, (2, 16, 16, 3), [])
    with torch.no_grad():
        tx, _, _, _ = m.sample_prepare(nchw(lr), nchw(up), noise=(x_t, {}), shape=(2, 3, 16, 16))
    np.testing.assert_allclose(nhwc(tx), np.asarray(x)[..., :3], rtol=0, atol=1e-6)
    # the start is q(img_lr_up, T - 1) with that noise
    sch, last = m.schedule, m.num_timesteps - 1
    want = float(sch.sqrt_alphas_cumprod[last]) * nchw(up) + float(sch.sqrt_one_minus_alphas_cumprod[last]) * x_t
    torch.testing.assert_close(tx, want, rtol=0, atol=1e-6)
    assert float((tx - x_t).abs().max()) > 0
    # a shape= the noise hook draws at
    with torch.no_grad():
        tx2, _, _, _ = m.sample_prepare(nchw(lr), nchw(up), generator=torch.Generator().manual_seed(0),
                                        shape=(2, 3, 16, 16))
    assert tuple(tx2.shape) == (2, 3, 16, 16)


@pytest.mark.parametrize("res", [True, False])
def test_ddim_sample_shape_matches_jax(res):
    """``ddim_sample(shape=...)`` draws a state of that shape: two samples
    (eta 1, 3 steps) for a batch-1 condition, residual and non-residual.
    The condition's projection comes to the state's batch (the kernel
    regions on the card take matching batches; JAX broadcasts it)."""
    d, params, m = stack(dict(CFG, res=res), seed=6)
    lr, up = (a[:1] for a in inputs(7))
    key = jax.random.PRNGKey(3)
    want, _ = d.ddim_sample(params, jnp.asarray(lr), jnp.asarray(up), key, num_steps=3, eta=1.0,
                            shape=(2, 16, 16, 3))
    ts, _ = m.ddim_timesteps(3)
    x_t, steps = jax_noise(key, (2, 16, 16, 3), ts)
    with torch.no_grad():
        got, _ = m.ddim_sample(nchw(lr), nchw(up), num_steps=3, eta=1.0, noise=(x_t, steps), shape=(2, 3, 16, 16))
        one, _ = m.ddim_sample(nchw(lr), nchw(up), num_steps=3, eta=1.0,
                               noise=(x_t[:1], {t: v[:1] for t, v in steps.items()}))
    assert tuple(got.shape) == (2, 3, 16, 16) and tuple(one.shape) == (1, 3, 16, 16)
    with torch.no_grad():
        _, cond, _, _ = m.sample_prepare(nchw(lr), nchw(up), noise=(x_t, steps), shape=(2, 3, 16, 16))
    assert cond.shape[0] == 2 and torch.equal(cond[0], cond[1])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(nhwc(one), np.asarray(want)[:1], rtol=0, atol=TOL)


@pytest.mark.parametrize("clip_input", [None, True, False])
def test_res2img_img2res_clip_input_override(tiny, clip_input):
    d, _, m = tiny
    g = np.random.default_rng(8)
    v = (g.standard_normal((1, 6, 6, 3)) * 2).astype(np.float32)  # outside [-1, 1]: the clip bites
    up = g.uniform(-1, 1, (1, 6, 6, 3)).astype(np.float32)
    for jf, tf in ((d.res2img, m.res2img), (d.img2res, m.img2res)):
        want = np.asarray(jf(jnp.asarray(v), jnp.asarray(up), clip_input=clip_input))
        got = nhwc(tf(nchw(v), nchw(up), clip_input=clip_input))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    unclipped = nhwc(m.res2img(nchw(v), nchw(up), clip_input=False))
    assert np.abs(unclipped - nhwc(m.res2img(nchw(v), nchw(up), clip_input=True))).max() > 0.1


# ------------------------------------------------------------------ C8 (SD)
UNET_NO_TABLE = dict(UNET_TINY, num_class_embeds=None)


def test_sd_unet_timestep_class_embedding_matches_jax():
    g = np.random.default_rng(11)
    x = g.standard_normal((2, 16, 16, 7)).astype(np.float32)
    t, labels = np.array([951, 1], np.int32), np.array([3, 350], np.int32)
    ctx = g.standard_normal((2, 7, 64)).astype(np.float32)
    ref = junet.UNet2DCondition.from_config(UNET_NO_TABLE)
    args = tuple(jnp.asarray(a) for a in (x, t, ctx, labels))
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), *args))["params"]
    assert {"class_embed_0", "class_embed_1"} <= set(shapes)
    rng = np.random.default_rng(12)

    def one(path, v):
        if str(path[-1].key) == "kernel":
            return (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(one, shapes)
    port = tunet.UNet2DCondition(UNET_NO_TABLE)
    sd = jax_sd_params_to_state_dict(tree, "unet")
    assert {"class_embedding.linear_1.weight", "class_embedding.linear_2.bias"} <= set(sd)
    port.load_state_dict(sd, strict=True)
    assert set(inv.unet_state_dict_shapes(UNET_NO_TABLE)) == set(port.state_dict())
    want = np.asarray(jit_quick(lambda p, *a: ref.apply({"params": p}, *a), tree, *args)(tree, *args))
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), torch.from_numpy(labels).long())
        no_labels = port(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    err = np.abs(nhwc(got) - want).max()
    assert err <= SD_TOL * np.abs(want).max(), (err, np.abs(want).max())
    assert float((got - no_labels).abs().max()) > 1e-3  # the labels reach the output


def test_published_unet_keeps_its_class_table():
    with torch.device("meta"):
        unet = tunet.UNet2DCondition(inv.X4_UNET_CONFIG)
    assert isinstance(unet.class_embedding, torch.nn.Embedding)
    assert tuple(unet.class_embedding.weight.shape) == (1000, 1024)  # 4 x block_out_channels[0]
