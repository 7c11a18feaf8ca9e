"""The whole slice: the port's ``SRDiffPipeline.upscale_batch_device``
against the JAX package's, on the CPU.

Both pipelines get the same params (random JAX params, carried
across by ``ckpt/jax_params.py``) and the same uint8 LR batch. The port's
noise hook is fed the JAX key stream: ``rng_init, rng_steps = split(rng)``,
``x_T = normal(rng_init)`` and, per step, ``normal(fold_in(rng_steps, t))``,
all at the padded HR shape. Mults 1|2|3|4 at hidden 8 make the UNet divide
the HR grid by 8, so the 7x9 LR input is reflect-padded to 8x10 and the
32x40 output cropped back to 28x36. Tolerance: 1e-4 absolute on the float
[0, 1] output (float32 through a 4-stage UNet per step, with the DDIM x0
step amplifying eps differences by up to sqrt((1 - a_t) / a_t)), and +-1 on
the uint8 output.
"""

import numpy as np
import pytest
import torch

import jax

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

from torch_port_helpers import random_jax_params

BASE = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8,
            unet_dim_mults="1|2|3|4", compute_dtype="float32")
SAMPLERS = {
    "ddim4_eta1": dict(sampler="ddim", sample_timesteps=4, ddim_eta=1.0),
    "ancestral_T8": dict(sampler="ddpm"),
}


def jax_noise(key, shape_nhwc, ts):
    """The JAX samplers' noise stream, as NCHW tensors for the port's hook."""
    k_init, k_steps = jax.random.split(key)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))  # noqa: E731
    x_t = to_t(jax.random.normal(k_init, shape_nhwc))
    steps = {int(t): to_t(jax.random.normal(jax.random.fold_in(k_steps, int(t)), shape_nhwc)) for t in ts}
    return x_t, steps


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_upscale_batch_device_matches_jax(sampler):
    cfg = dict(BASE, **SAMPLERS[sampler])
    jhp = JHparams(cfg)
    _, params = random_jax_params(jhp, 1)
    jpipe = JaxPipeline(jhp, params=params, mesh=make_mesh("", devices=jax.devices()[:1]))
    tpipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(params), device="cpu")

    imgs = np.random.default_rng(6).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    if cfg["sampler"] == "ddim":
        ts, _ = tpipe.model.ddim_timesteps(cfg["sample_timesteps"])
    else:
        ts = range(cfg["timesteps"])
    noise = jax_noise(key, (2, 32, 40, 3), ts)

    ref = np.asarray(jpipe.upscale_batch_device(imgs, rng=key))
    got = tpipe.upscale_batch_device(imgs, noise=noise)
    assert tuple(got.shape) == ref.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)

    # the JAX program's uint8 output is round(out * 255) of the same float output
    ref8 = np.round(ref * 255.0).astype(np.uint8)
    got8 = tpipe.upscale_batch_device(imgs, as_uint8=True, noise=noise)
    assert got8.dtype == torch.uint8
    assert np.abs(got8.numpy().astype(np.int16) - ref8.astype(np.int16)).max() <= 1
