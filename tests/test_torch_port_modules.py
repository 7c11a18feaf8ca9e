"""The port's modules against the JAX package's, with the JAX params carried
across by ``ckpt/jax_params.py``.

A tiny SRDiff stack (hidden 8, mults 1|2|3, RRDB nb 2 / nf 8, T 8, float32)
gets random JAX params (biases too), and the tree is converted to
the port's ``state_dict`` and loaded with ``strict=True``. Each module then
runs on the same numpy inputs in both frameworks (NHWC there, NCHW here).
Tolerance: 5e-5 absolute + 1e-4 relative in float32, for sums taken in
another order through up to ~30 convs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ckpt.torch_import import export_srdiff_to_torch_keys
from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from dgm_img_super_resolution_tpu.models import layers as jl
from dgm_img_super_resolution_tpu.models.factory import build_srdiff as jax_build_srdiff
from dgm_img_super_resolution_tpu.ops import image as ji
from dgm_img_super_resolution_tpu.ops.resize import nearest_upsample as jax_nearest_upsample
from dgm_img_super_resolution_tpu.ops.resize import resize as jax_resize
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.diffusion.schedule import BUFFERS, schedule_arrays
from dgm_img_super_resolution_tpu_torch.models import layers as tl
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff
from dgm_img_super_resolution_tpu_torch.ops import image as ti
from dgm_img_super_resolution_tpu_torch.ops import resize as tr

from torch_port_helpers import random_jax_params

TINY = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8,
            unet_dim_mults="1|2|3", compute_dtype="float32", up_input=True)
TOL = dict(rtol=1e-4, atol=5e-5)


@pytest.fixture(scope="module")
def stacks():
    d, params = random_jax_params(JHparams(TINY), 0)
    model = build_srdiff(Hparams(TINY))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return d, params, model.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def test_state_dict_keys_match_the_reference_export(stacks):
    _, params, model = stacks
    ref = export_srdiff_to_torch_keys(params)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_mish_and_pos_emb():
    x = np.linspace(-30, 30, 601).astype(np.float32)
    np.testing.assert_allclose(tl.mish(torch.from_numpy(x)).numpy(), np.asarray(jl.mish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    t = np.array([0, 1, 5, 99], np.int64)
    np.testing.assert_allclose(tl.sinusoidal_pos_emb(torch.from_numpy(t), 16).numpy(),
                               np.asarray(jl.sinusoidal_pos_emb(jnp.asarray(t), 16)), rtol=1e-6, atol=1e-6)


def test_blocks_and_resampling(stacks):
    _, params, model = stacks
    p, u = params["denoise_fn"], model.denoise_fn
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    temb = rng.standard_normal((2, 8)).astype(np.float32)
    with torch.no_grad():
        # Block (block1 of down stage 1, 8 -> 16)
        ref = jl.Block(16).apply({"params": p["down_1_res1"]["block1"]}, jnp.asarray(x))
        np.testing.assert_allclose(nhwc(u.downs[1][0].block1(nchw(x))), np.asarray(ref), **TOL)
        # ResnetBlock with a time embedding
        ref = jl.ResnetBlock(16, 8).apply({"params": p["down_1_res1"]}, jnp.asarray(x), jnp.asarray(temb))
        got = u.downs[1][0](nchw(x), torch.from_numpy(temb))
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
        # ResnetBlock with the [x || skip] join (up stage 0: 24 + 24 -> 16)
        xs, sk = (rng.standard_normal((2, 4, 6, 24)).astype(np.float32) for _ in range(2))
        ref = jl.ResnetBlock(16, 8).apply({"params": p["up_0_res1"]}, jnp.asarray(xs), jnp.asarray(temb),
                                          skip=jnp.asarray(sk))
        got = u.ups[0][0](nchw(xs), torch.from_numpy(temb), skip=nchw(sk))
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
        # Upsample (ConvT k4 s2 p1) and Downsample (reflect stride-2 3x3)
        xu = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
        ref = jl.Upsample().apply({"params": p["up_0_upsample"]}, jnp.asarray(xu))
        np.testing.assert_allclose(nhwc(u.ups[0][2](nchw(xu))), np.asarray(ref), **TOL)
        xd = rng.standard_normal((2, 6, 10, 16)).astype(np.float32)
        ref = jl.Downsample().apply({"params": p["down_1_downsample"]}, jnp.asarray(xd))
        got = u.downs[1][2](nchw(xd))
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_rrdb_with_features(stacks):
    d, params, model = stacks
    x = np.random.default_rng(2).uniform(-1, 1, (2, 6, 9, 3)).astype(np.float32)
    out_j, feas_j = d.rrdb.apply({"params": params["rrdb"]}, jnp.asarray(x), True)
    with torch.no_grad():
        out_t, feas_t = model.rrdb(nchw(x), True)
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), **TOL)
    assert len(feas_t) == len(feas_j) == 3
    for ft, fj in zip(feas_t, feas_j):
        np.testing.assert_allclose(nhwc(ft), np.asarray(fj), **TOL)


@pytest.mark.parametrize("hoist", [False, True])
def test_unet_forward(stacks, hoist):
    """Plain (cond projected and up_proj added inside every call) and with
    the project_only hoist (both folded into one tensor outside)."""
    d, params, model = stacks
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    lr_up = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    p = {"params": params["denoise_fn"]}
    unet = model.denoise_fn
    with torch.no_grad():
        if hoist:
            cj = d.denoise_fn.apply(p, None, None, jnp.asarray(cond), jnp.asarray(lr_up), project_only=True)
            ref = d.denoise_fn.apply(p, jnp.asarray(x), jnp.asarray(t), cj, None,
                                     cond_projected=True, up_folded=True)
            ct = unet.project(nchw(cond), nchw(lr_up))
            np.testing.assert_allclose(nhwc(ct), np.asarray(cj), **TOL)
            got = unet(nchw(x), torch.from_numpy(t), ct, None, cond_projected=True, up_folded=True)
        else:
            ref = d.denoise_fn.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(lr_up))
            got = unet(nchw(x), torch.from_numpy(t), nchw(cond), nchw(lr_up))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "quad", "warmup10", "warmup50", "const", "jsd"])
@pytest.mark.parametrize("res", [True, False])
def test_schedule_buffers(schedule, res):
    kw = dict(timesteps=20, beta_schedule=schedule, beta_s=0.008, beta_start=1e-4, beta_end=2e-2, res=res)
    ours = schedule_arrays(**kw)
    ref = jax_make_schedule(**kw)
    assert len(BUFFERS) == 12
    for name in BUFFERS:
        assert ours[name].dtype == np.float64
        # float64 here, float32 there: equal after the same rounding
        np.testing.assert_array_equal(ours[name].astype(np.float32), np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("T,n", [(100, 20), (100, 7), (8, 4), (8, None), (1000, 50)])
def test_ddim_timesteps(T, n):
    hp = dict(TINY, timesteps=T)
    ts_t, tp_t = build_srdiff(Hparams(hp)).ddim_timesteps(n)
    ts_j, tp_j = jax_build_srdiff(JHparams(hp)).ddim_timesteps(n)
    assert ts_t == np.asarray(ts_j).tolist()
    assert tp_t == np.asarray(tp_j).tolist()


def test_image_value_range_and_resize():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(ti.uint8_to_pm1(u8).numpy(), np.asarray(ji.uint8_to_pm1(u8)))
    f = np.linspace(-1.2, 1.2, 1001).astype(np.float32)
    np.testing.assert_array_equal(ti.pm1_to_uint8(torch.from_numpy(f)), ji.pm1_to_uint8(f))
    x = np.random.default_rng(3).uniform(-1, 1, (2, 7, 9, 3)).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), (28, 36), variant="torch")
    np.testing.assert_allclose(nhwc(tr.resize(nchw(x), (28, 36))), np.asarray(ref), rtol=1e-5, atol=1e-6)
    ref = jax_nearest_upsample(jnp.asarray(x), 2)
    np.testing.assert_array_equal(nhwc(tr.nearest_upsample(nchw(x), 2)), np.asarray(ref))


def test_residual_regime_and_posterior(stacks):
    d, _, model = stacks
    rng = np.random.default_rng(5)
    x, lr_up, eps = (rng.uniform(-1.5, 1.5, (2, 6, 10, 3)).astype(np.float32) for _ in range(3))
    jx, jlr, jeps = jnp.asarray(x), jnp.asarray(lr_up), jnp.asarray(eps)
    np.testing.assert_allclose(nhwc(model.res2img(nchw(x), nchw(lr_up))), np.asarray(d.res2img(jx, jlr)), **TOL)
    np.testing.assert_allclose(nhwc(model.img2res(nchw(x), nchw(lr_up))), np.asarray(d.img2res(jx, jlr)), **TOL)
    t = 5
    tb = jnp.full((2,), t, jnp.int32)
    x0 = model.predict_start_from_noise(nchw(x), t, nchw(eps))
    np.testing.assert_allclose(nhwc(x0), np.asarray(d.predict_start_from_noise(jx, tb, jeps)), **TOL)
    mean, var, log_var = model.q_posterior(x0, nchw(x), t)
    j_mean, j_var, j_log_var = d.q_posterior(jnp.asarray(nhwc(x0)), jx, tb)
    np.testing.assert_allclose(nhwc(mean), np.asarray(j_mean), **TOL)
    np.testing.assert_allclose([var, log_var], [float(j_var[0, 0, 0, 0]), float(j_log_var[0, 0, 0, 0])],
                               rtol=1e-6)
