"""The port's importer of the upstream SRDiff checkpoint
(``ckpt/torch_import.py``), held against the JAX package's, on the CPU.

The file is written in the upstream format from the JAX package's
``export_srdiff_to_torch_keys`` of random JAX params: ``state_dict`` and
``model`` wrappers, every key under ``model.``, the diffusion buffers
beside the weights, and a ``global_step``. The port's import must equal
the export key for key and bit for bit; the pipeline loaded from the file
runs the UNet forward as JAX does on the same params (5e-5 absolute + 1e-4
relative in float32, the port's forward tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ckpt import torch_import as jti
from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu_torch.ckpt import torch_import as tti
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

from torch_port_helpers import random_jax_params

TINY = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8,
            unet_dim_mults="1|2", compute_dtype="float32")
BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
           "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
           "sqrt_recipm1_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
           "posterior_mean_coef1", "posterior_mean_coef2")


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """(JAX denoiser, JAX params, the export, the checkpoint file)."""
    d, params = random_jax_params(JHparams(TINY), 3)
    export = jti.export_srdiff_to_torch_keys(params)
    model = {f"model.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in export.items()}
    model.update({f"model.{b}": torch.linspace(0, 1, 8, dtype=torch.float64) for b in BUFFERS})
    model["model.ssim_loss.window"] = torch.ones(1, 1, 11, 11)
    path = tmp_path_factory.mktemp("ckpt") / "model_ckpt_steps_400000.ckpt"
    torch.save({"state_dict": {"model": model}, "global_step": 400000, "epoch": 7}, path)
    return d, params, export, path


def test_import_equals_the_export_key_for_key(upstream):
    _, params, export, path = upstream
    sd, step = tti.import_srdiff_checkpoint(str(path))
    assert step == 400000
    assert set(sd) == set(export)
    for k, v in export.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the same dict the port carries across from the JAX params
    carried = jax_params_to_state_dict(params)
    assert all(torch.equal(sd[k], carried[k]) for k in carried)
    # the JAX importer reads the same file
    jparams, jstep = jti.import_srdiff_checkpoint(str(path))
    assert jstep == step


def test_pipeline_from_the_file_runs_the_unet_as_jax(upstream):
    d, params, export, path = upstream
    pipe = SRDiffPipeline(Hparams(TINY), ckpt_path=str(path), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    lr_up = rng.uniform(-1, 1, (2, 8, 12, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    ref = jax.jit(d.denoise_fn.apply)({"params": params["denoise_fn"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                             jnp.asarray(lr_up))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))  # noqa: E731
    with torch.no_grad():
        got = pipe.model.denoise_fn(nchw(x), torch.from_numpy(t), nchw(cond), nchw(lr_up))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-4, atol=5e-5)
    # params given win over the file
    zeros = {k: torch.zeros(v.shape) for k, v in pipe.model.state_dict().items()}
    other = SRDiffPipeline(Hparams(TINY), params=zeros, ckpt_path=str(path), device="cpu")
    assert all(float(v.abs().sum()) == 0 for v in other.model.state_dict().values())


def test_unknown_keys_raise_and_bare_files_load(upstream, tmp_path, capsys):
    _, _, export, _ = upstream
    bare = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export.items()}
    path = tmp_path / "bare.ckpt"
    torch.save(bare, path)
    sd, step = tti.import_srdiff_checkpoint(str(path))
    assert step == 0 and set(sd) == set(export)
    for extra in ("optimizer.state", "denoise_fn.downs.0.0.block9.weight", "rrdb.extra_conv.weight"):
        torch.save({"state_dict": {"model": {**bare, extra: torch.zeros(2)}}, "global_step": 5}, path)
        with pytest.raises(KeyError, match="cannot translate"):
            jti.import_srdiff_checkpoint(str(path))
        with pytest.raises(KeyError, match="cannot translate"):
            tti.import_srdiff_checkpoint(str(path))
        sd, step = tti.import_srdiff_checkpoint(str(path), strict=False)
        assert step == 5 and set(sd) == set(export)
        assert "1 unused keys" in capsys.readouterr().out
    # a missing weight fails the pipeline's strict load
    torch.save({k: v for k, v in bare.items() if k != "denoise_fn.final_conv.1.bias"}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        SRDiffPipeline(Hparams(TINY), ckpt_path=str(path), device="cpu")
