"""The port's latent interpolation and operating-point check against the JAX
package's, on the CPU, with JAX's noise fed through the port's hooks.

- ``GaussianDiffusion.interpolate`` and ``SRDiffPipeline.interpolate``:
  JAX splits its key into k1, k2 (the two ``q_sample`` draws) and
  rng_steps, and step t draws from ``fold_in(rng_steps, t)``; the port is
  fed exactly those arrays. Tolerance 1e-4 on the [0, 1] output (float32
  through the chain of T-1 UNet steps, as the serve's).
- ``validate_operating_point``: each sampler of image i is fed the stream
  of ``fold_in(key, i)``; the dicts have the same keys and their PSNRs
  agree within 1e-2 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgm_img_super_resolution_tpu.inference as jinf
from dgm_img_super_resolution_tpu import validation as jval
from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.ops.image import uint8_to_pm1
from dgm_img_super_resolution_tpu.ops.resize import resize as jresize
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch import validation as tval
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

from torch_port_helpers import jax_noise, random_jax_params

TINY = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2",
            compute_dtype="float32")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def interp_noise(key, shape, t):
    """JAX ``interpolate``'s draws as the port's ``(eps_1, eps_2, {t: eps_t})``."""
    k1, k2, rng_steps = jax.random.split(key, 3)
    steps = {ti: nchw(jax.random.normal(jax.random.fold_in(rng_steps, ti), shape)) for ti in range(1, t)}
    return nchw(jax.random.normal(k1, shape)), nchw(jax.random.normal(k2, shape)), steps


@pytest.fixture(scope="module")
def stacks():
    jhp = JHparams(TINY)
    d, params = random_jax_params(jhp, 2)
    tpipe = SRDiffPipeline(Hparams(TINY), params=jax_params_to_state_dict(params), device="cpu")
    return jhp, d, params, tpipe


@pytest.fixture(scope="module")
def jax_interp(stacks):
    """Two uint8 HR images, the JAX key, and the JAX pipeline's
    ``interpolate`` of them at lam 0.3 (t = T-1)."""
    jhp, _, params, _ = stacks
    jpipe = jinf.SRDiffPipeline(jhp, params=params, mesh=make_mesh("", devices=jax.devices()[:1]))
    g = np.random.default_rng(4)
    a, b = (g.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2))
    key = jax.random.PRNGKey(6)
    return a, b, key, jpipe.interpolate(a, b, lam=0.3, rng=key)


def test_gaussian_interpolate_matches_jax(stacks, jax_interp):
    """The port's ``GaussianDiffusion.interpolate`` on the LR and LR-up the
    JAX pipeline computes (its MATLAB and torch resizes)."""
    _, _, _, tpipe = stacks
    a, b, key, ref = jax_interp
    x1, x2 = (np.asarray(uint8_to_pm1(v))[None] for v in (a, b))
    lr = jresize(jnp.asarray(x1), (4, 4), variant="matlab")
    lr_up = np.asarray(jresize(lr, (16, 16), variant="torch"))
    t = TINY["timesteps"] - 1
    with torch.inference_mode():
        out = tpipe.model.interpolate(nchw(x1), nchw(x2), nchw(lr), nchw(lr_up), t=t, lam=0.3,
                                      noise=interp_noise(key, x1.shape, t))
    got = (out * 0.5 + 0.5).clamp(0, 1)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_pipeline_interpolate_matches_jax(stacks, jax_interp):
    _, _, _, tpipe = stacks
    a, b, key, ref = jax_interp
    got = tpipe.interpolate(a, b, lam=0.3, noise=interp_noise(key, (1, 16, 16, 3), TINY["timesteps"] - 1))
    assert got.shape == ref.shape == (16, 16, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # drawn from a generator: finite, in range, the same for the same seed
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    out = tpipe.interpolate(a, b, t=3, generator=gen())
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    np.testing.assert_array_equal(out, tpipe.interpolate(a, b, t=3, generator=gen()))


def test_validate_operating_point_matches_jax(stacks, monkeypatch):
    jhp, _, params, _ = stacks
    assert tval.recorded_operating_point() == jval.recorded_operating_point()
    assert tval.recorded_operating_point("/nonexistent.json") == jval.recorded_operating_point("/nonexistent.json")
    # the JAX pipelines of the check on one device, as the port's run on one
    one = make_mesh("", devices=jax.devices()[:1])
    monkeypatch.setattr(jinf, "make_mesh", lambda spec="", devices=None: one)
    g = np.random.default_rng(7)
    pairs = [(g.integers(0, 256, (4, 4, 3), dtype=np.uint8), g.integers(0, 256, (16, 16, 3), dtype=np.uint8))
             for _ in range(2)]
    op = {"sampler": "ddim", "steps": 4, "eta": 1.0, "enc_interval": 1}
    key = jax.random.PRNGKey(8)
    want = jval.validate_operating_point(jhp, params, pairs, op=op, rng=key)
    ddim_ts = list(np.linspace(0, TINY["timesteps"] - 1, 4).round().astype(int))
    ts = {"golden": range(TINY["timesteps"]), "op": ddim_ts}
    noise = lambda name, i: jax_noise(jax.random.fold_in(key, i), (1, 16, 16, 3), ts[name])  # noqa: E731
    got = tval.validate_operating_point(Hparams(TINY), jax_params_to_state_dict(params), pairs, op=op,
                                        device="cpu", noise=noise)
    assert set(got) == set(want)
    for k in ("ancestral_mean_psnr_vs_hr", "op_mean_psnr_vs_hr", "delta_db"):
        assert abs(got[k] - want[k]) <= 1e-2, (k, got[k], want[k])
    for k in ("operating_point", "tol_db", "n_images"):
        assert got[k] == want[k]
    assert got["within_tol"] == (got["delta_db"] <= got["tol_db"])
