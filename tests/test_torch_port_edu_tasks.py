"""The AE, VAE and DDPM tasks of the port held against the JAX package's on
the CPU (``train/tasks/vae.py``, ``diffusion/ddpm.py``).

Each task's loss and its gradient with respect to every parameter, on the
same params (the JAX init's shapes filled from a numpy seed, carried across
by ``ckpt/jax_params.py``; a gradient tree maps through the same function)
and the same batch, with JAX's draws fed to the port: the VAE's eps from
the key its ``reparameterize`` reads, the DDPM's t and noise from the two
keys its loss splits. Then the samplers with JAX's draws (the VAE decode of
``normal(key)``, the DDPM chain over T = 4 with ``split`` and
``fold_in(rng_steps, t)``), and a few trainer steps on the CPU.

Bounds: float32 losses within 1e-5 relative; gradients within 1e-4 of their
tensor's largest |JAX gradient|, as ``tests/test_torch_port_autograd.py``;
samples within 1e-5 absolute (the DDPM chain: 5e-5, four UNet calls whose
eps the x0 step scales by up to sqrt(1 / a_t) at the noisiest step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.data.mnist import synthetic_mnist, to_model_input
from dgm_img_super_resolution_tpu.train.tasks import vae as jtasks
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_module_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.train.tasks import vae as ttasks

from torch_port_helpers import jax_noise, jit_quick

LOSS_RTOL, GRAD_TOL, SAMPLE_TOL, CHAIN_TOL = 1e-5, 1e-4, 1e-5, 5e-5
HP = dict(compute_dtype="float32", lr=1e-3, clip_grad_norm=10.0, val_check_interval=0, tb_log_interval=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def fill(tree, seed):
    """Kernels N(0, 1/fan_in), other leaves N(0, 0.01), from a numpy seed."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        if str(path[-1].key) == "kernel":
            return (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def batch(n, size, seed, unit=True):
    x = to_model_input(synthetic_mnist(n, seed=seed)[0], size)
    return (x + 1.0) / 2.0 if unit else x  # [0, 1] for the sigmoid decoders, [-1, 1] for the DDPM


def check_loss_and_grads(jtask, ttask, x, jkey, loss_kw, seed):
    params = fill(jax.eval_shape(lambda: jtask.init_params(jax.random.PRNGKey(0))), seed)
    model, named = ttask.model, _inner(ttask.model)
    named.load_state_dict(jax_module_params_to_state_dict(named, params), strict=True)

    def jloss(p, xb, k):
        return jtask.loss_fn(p, {"x": xb}, k)

    (jl, jaux), jg = jit_quick(jax.value_and_grad(jloss, has_aux=True), params, jnp.asarray(x), jkey)(
        params, jnp.asarray(x), jkey)
    model.zero_grad(set_to_none=True)
    tl, taux = ttask.loss_fn(model, {"x": nchw(x)}, None, **loss_kw)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    want = jax_module_params_to_state_dict(named, jg)
    got = dict(named.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        bound = GRAD_TOL * float(g.abs().max())
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), rtol=0, atol=bound, err_msg=name)
    return params


def _inner(model):
    """The module whose names are the flax ones (the DDPM's UNet)."""
    return getattr(model, "model", model)


def test_ae_loss_and_grads_match_jax():
    jt, tt = jtasks.AETask(JHparams(**HP)), ttasks.AETask(Hparams(**HP), device="cpu")
    check_loss_and_grads(jt, tt, batch(4, 32, 0), jax.random.PRNGKey(0), {}, 1)


def test_vae_loss_grads_and_sample_match_jax():
    jt = jtasks.VAETask(JHparams(**HP), latent_dim=4)
    tt = ttasks.VAETask(Hparams(**HP), latent_dim=4, device="cpu")
    key = jax.random.PRNGKey(5)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (4, 4))))  # VAE.reparameterize's draw from the key
    params = check_loss_and_grads(jt, tt, batch(4, 32, 1), key, {"eps": eps}, 2)
    skey = jax.random.PRNGKey(9)
    want = np.asarray(jt.sample(params, skey, n=3))
    z = torch.from_numpy(np.array(jax.random.normal(skey, (3, 4))))
    got = tt.sample(tt.model, n=3, z=z)
    assert tuple(got.shape) == (3, 1, 32, 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=SAMPLE_TOL)


DDPM_HP = dict(HP, ddpm_dim=8, ddpm_timesteps=4)


def test_ddpm_loss_and_grads_match_jax():
    """At ``ddpm_dim`` 16, so that each of the 8 GroupNorm groups holds 2 or
    more channels: with one channel a group, the preceding conv's bias has
    a gradient of exactly 0, which both sides give as rounding noise."""
    hp = dict(DDPM_HP, ddpm_dim=16)
    jt = jtasks.DDPMTask(JHparams(**hp), img_hw=8)
    tt = ttasks.DDPMTask(Hparams(**hp), img_hw=8, device="cpu")
    x = batch(3, 8, 2, unit=False)
    key = jax.random.PRNGKey(7)
    k_t, k_n = jax.random.split(key)  # the two draws DDPM.loss splits its key into
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (3,), 0, 4))).long()
    noise = nchw(jax.random.normal(k_n, x.shape))
    check_loss_and_grads(jt, tt, x, key, {"t": t, "noise": noise}, 3)


def test_ddpm_sample_matches_jax():
    jt = jtasks.DDPMTask(JHparams(**DDPM_HP), img_hw=8)
    tt = ttasks.DDPMTask(Hparams(**DDPM_HP), img_hw=8, device="cpu")
    params = fill(jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0))), 4)
    tt.model.model.load_state_dict(jax_module_params_to_state_dict(tt.model.model, params), strict=True)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jit_quick(lambda p, k: jt.sample(p, k, n=2), params, key)(params, key))
    got = tt.sample(tt.model, n=2, noise=jax_noise(key, (2, 8, 8, 1), range(1, 4)))
    assert tuple(got.shape) == (2, 1, 8, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=CHAIN_TOL)


@pytest.mark.parametrize("task", ["ae", "vae", "ddpm"])
def test_trainer_steps_on_the_cpu(task):
    """``make_trainer`` gives ``train/trainer.py:Trainer``; a few steps on one batch run,
    log finite metrics and (AE, VAE) lower the loss."""
    hp = Hparams(**DDPM_HP)
    tt = {"ae": lambda: ttasks.AETask(hp, device="cpu"),
          "vae": lambda: ttasks.VAETask(hp, latent_dim=4, device="cpu"),
          "ddpm": lambda: ttasks.DDPMTask(hp, img_hw=8, device="cpu")}[task]()
    trainer = tt.make_trainer()
    assert trainer.device == torch.device("cpu")
    state = trainer.init_state(0)
    b = {"x": batch(8, 8 if task == "ddpm" else 32, 5, unit=task != "ddpm")}
    g = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        state, m = trainer.train_step(state, b, g)
        assert all(np.isfinite(float(v)) for v in m.values())
        losses.append(float(m["loss"]))
    assert state.step == 4
    if task != "ddpm":
        assert losses[-1] < losses[0]
    if task == "vae":
        assert float(m["kl"]) >= 0
