"""The port's diffusion training losses and their gradients, held against
the JAX package's on the CPU (``diffusion/gaussian.py`` training half).

One tiny SRDiff stack (hidden 16, mults 1|2, RRDB 2 blocks x 8 features,
T = 100, HR 32, B = 2), the same weights on both sides (the JAX tree
carried across by ``ckpt/jax_params.py``; a gradient tree maps through the
same function, whose layout changes are permutations), the same batch, and
the JAX draws fed to the port: t from ``randint`` and the noise from
``normal`` on the keys ``training_losses`` splits, so the two rows of the
batch sit at different timesteps. The RRDB trains (``fix_rrdb`` false) with
its aux l1 and SSIM losses; the l1 gradients and the float32 forward share
one JAX compile.

Bounds: float32 losses within 1e-5 relative and the three images within
1e-5 (float32 sums in another order through the UNet and the RRDB);
gradients within 1e-4 of their tensor's largest |JAX gradient|, as the
backward tests of the regions (``test_torch_port_autograd.py``); bf16 loss
within ``BF16_LOSS_TOL`` relative: both sides round every conv's output to
bf16 but sum in other orders, so single bf16 roundings (2^-8 relative)
differ and pass through the UNet; the loss averages them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.models.factory import build_srdiff as jax_build_srdiff
from dgm_img_super_resolution_tpu.train.tasks.srdiff import SRDiffTask as JaxTask
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

from torch_port_helpers import jit_quick, random_jax_params

LOSS_TOL, IMG_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
BF16_LOSS_TOL = 2e-2
TINY = dict(hidden_size=16, unet_dim_mults="1|2", rrdb_num_block=2, rrdb_num_feat=8, timesteps=100,
            patch_size=32, rrdb_ckpt="")
AUX = dict(fix_rrdb=False, aux_l1_loss=True, aux_ssim_loss=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def make_batch(seed=0, b=2, hr=32):
    g = np.random.default_rng(seed)
    hr_img = g.uniform(-1, 1, (b, hr, hr, 3)).astype(np.float32)
    lr = g.uniform(-1, 1, (b, hr // 4, hr // 4, 3)).astype(np.float32)
    lr_up = np.clip(hr_img + 0.2 * g.standard_normal(hr_img.shape), -1, 1).astype(np.float32)
    return {"hr": hr_img, "lr": lr, "lr_up": lr_up}


def jax_draws(key, b, shape, T):
    """What ``training_losses(..., rng=key)`` draws: (t, eps, eps_step) as
    torch tensors (noise NCHW)."""
    rng_t, rng_p = jax.random.split(key)
    t = jax.random.randint(rng_t, (b,), 0, T)
    eps = jax.random.normal(rng_p, shape, jnp.float32)
    eps_step = jax.random.normal(jax.random.fold_in(rng_p, 1), shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), (nchw(eps), nchw(eps_step))


def distinct_t_key(b=2, T=100):
    """The first key whose drawn timesteps differ across the batch."""
    for s in range(100):
        key = jax.random.PRNGKey(s)
        t = np.asarray(jax.random.randint(jax.random.split(key)[0], (b,), 0, T))
        if len(set(t.tolist())) == b:
            return key
    raise AssertionError("no key with distinct timesteps")


def port_model(hp, params):
    m = build_srdiff(hp)
    m.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return m


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / max(np.abs(np.asarray(b, np.float64)).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    """The key, the batch (NHWC numpy; NCHW tensors) and one JAX param tree
    (the loss type, dtype and ``fix_rrdb`` leave its shapes as they are)."""
    key = distinct_t_key()
    batch = make_batch()
    _, params = random_jax_params(JHparams(**TINY), seed=1)
    return key, batch, {k: nchw(v) for k, v in batch.items()}, params


def jax_run(params, batch, key, loss_type="l1", dtype="float32", grads=True, fwd=True):
    """One JAX compile on ``key``: ``value_and_grad`` of
    ``SRDiffTask.loss_fn`` (``grads``) and ``training_losses`` with its
    images (``fwd``)."""
    hp = JHparams(**TINY, **AUX, compute_dtype=dtype, loss_type=loss_type)
    d = jax_build_srdiff(hp)
    vg = jax.value_and_grad(JaxTask(hp, d).loss_fn, has_aux=True)

    def run(p, b, k):
        return (vg(p, b, k) if grads else None,
                d.training_losses(p, b["hr"], b["lr"], b["lr_up"], k) if fwd else None)

    return jit_quick(run, params, batch, key)(params, batch, key)


@pytest.fixture(scope="module")
def jax_l1(setup):
    """The l1 loss's gradients and the float32 forward, one compile."""
    key, batch, _, params = setup
    return jax_run(params, batch, key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_losses_match_jax(setup, jax_l1, dtype):
    """The losses (q and the RRDB's aux l1 and SSIM), the three images and
    t of ``training_losses``; float32 within LOSS_TOL / IMG_TOL, bf16 within
    BF16_LOSS_TOL."""
    key, batch, tb, params = setup
    fwd = jax_l1[1] if dtype == "float32" else jax_run(params, batch, key, dtype=dtype, grads=False)[1]
    j_losses, j_imgs, j_t = fwd
    t, noise = jax_draws(key, 2, batch["hr"].shape, 100)
    assert len(set(t.tolist())) == 2
    hp = Hparams(**TINY, **AUX, compute_dtype=dtype)
    m = port_model(hp, params)
    with torch.no_grad():
        losses, imgs, t_out = m.training_losses(tb["hr"], tb["lr"], tb["lr_up"], t=t, noise=noise)
    assert torch.equal(t_out, torch.from_numpy(np.array(j_t)).long())
    assert sorted(losses) == sorted(j_losses) == ["aux_l1", "aux_ssim", "q"]
    tol = LOSS_TOL if dtype == "float32" else BF16_LOSS_TOL
    for k in losses:
        assert abs(float(losses[k]) - float(j_losses[k])) <= tol * abs(float(j_losses[k])), k
    if dtype == "float32":
        for got, want in zip(imgs, j_imgs):
            assert float((got - nchw(want)).abs().max()) <= IMG_TOL


def test_posterior_step_and_q_moments_match_jax():
    """``p_sample_from_pred`` and ``q_mean_variance`` at per-row t (t = 0
    takes no noise) against JAX."""
    hp = dict(TINY, compute_dtype="float32")
    d, m = jax_build_srdiff(JHparams(**hp)), build_srdiff(Hparams(**hp))
    g = np.random.default_rng(4)
    x, eps, z = (g.standard_normal((3, 8, 8, 3)).astype(np.float32) for _ in range(3))
    t = np.array([0, 41, 99], np.int32)
    mean, _, logv, x0 = d.p_mean_variance(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
    nz = (t > 0).astype(np.float32)[:, None, None, None]
    want = np.asarray(mean) + nz * np.exp(0.5 * np.asarray(logv)) * z
    got, got_x0 = m.p_sample_from_pred(nchw(x), torch.from_numpy(t).long(), nchw(eps), nchw(z))
    assert float((got - nchw(want)).abs().max()) <= 1e-5
    assert float((got_x0 - nchw(x0)).abs().max()) <= 1e-5
    qm, qv, ql = d.q_mean_variance(jnp.asarray(x), jnp.asarray(t))
    pm, pv, pl = m.q_mean_variance(nchw(x), torch.from_numpy(t).long())
    assert float((pm - nchw(qm)).abs().max()) <= 1e-6
    assert np.allclose(pv.flatten().numpy(), np.asarray(qv).reshape(-1), rtol=1e-6, atol=0)
    assert np.allclose(pl.flatten().numpy(), np.asarray(ql).reshape(-1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("loss_type", ["l1", "l2", "ssim"])
def test_loss_gradients_match_jax(setup, jax_l1, loss_type):
    """d(loss)/d(every parameter) of ``SRDiffTask.loss_fn`` with the RRDB
    trained (``fix_rrdb`` false) and its aux l1 and SSIM losses on."""
    key, batch, tb, params = setup
    hp = dict(TINY, **AUX, compute_dtype="float32", loss_type=loss_type)
    ((j_loss, j_metrics), j_grads), _ = jax_l1 if loss_type == "l1" else jax_run(params, batch, key, loss_type,
                                                                                  fwd=False)
    t, noise = jax_draws(key, 2, batch["hr"].shape, 100)
    task = SRDiffTask(Hparams(**hp), port_model(Hparams(**hp), params))
    loss, metrics = task.loss_fn(task.diffusion, tb, t=t, noise=noise)
    loss.backward()
    assert sorted(metrics) == sorted(j_metrics) == ["aux_l1", "aux_ssim", "q"]
    for k in metrics:
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= LOSS_TOL * abs(float(j_metrics[k])), k
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    got = {n: p.grad for n, p in task.diffusion.named_parameters()}
    assert sorted(got) == sorted(want)
    worst = {n: rel(got[n].numpy(), w.numpy()) for n, w in want.items()}
    assert max(worst.values()) <= GRAD_TOL, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_fixed_rrdb_takes_no_gradient(setup):
    """Under ``fix_rrdb`` (the config's default) the encoder runs without
    grad, JAX's ``stop_gradient``: no RRDB parameter gets a gradient, and
    the UNet's do."""
    tb = setup[2]
    m = build_srdiff(Hparams(**TINY, compute_dtype="float32"))
    losses, _, _ = m.training_losses(tb["hr"], tb["lr"], tb["lr_up"], t=torch.tensor([3, 70]),
                                     generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    assert list(losses) == ["q"]
    assert all(p.grad is None for p in m.rrdb.parameters())
    assert all(p.grad is not None for p in m.denoise_fn.parameters())
