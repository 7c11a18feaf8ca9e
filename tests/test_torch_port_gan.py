"""The GAN tasks of the port held against the JAX package's on the CPU
(``train/tasks/gan.py``): one whole adversarial round per kind (simple GAN,
DCGAN, WGAN-GP with ``crit_repeats`` 2, so the critic's second update
starts from the first's parameters, statistics and Adam moments), the
validation losses, then the port's ``fit``, ``generate`` and model IO.

Both sides start from the JAX ``init_state`` at the published widths (its
params, BatchNorm statistics and Adam moments carried across by
``ckpt/jax_params.py``), take the same NHWC batch of ``synthetic_mnist`` at
28x28 and JAX's draws: per update k the generator input
``normal(fold_in(fold_in(rng, k), 0))`` and the WGAN-GP mix
``uniform(fold_in(fold_in(rng, k), 1))``, and the generator update's
``normal(fold_in(rng, 1000))``. The round is compared update by update,
each from the JAX state before it (JAX's ``train_step`` is the sequence of
its ``_disc_update`` and ``_gen_update``; the port's ``train_step`` is held
bit for bit to the same sequence of its own): a conv bias that feeds a
train-mode BatchNorm has a gradient of exactly 0, so Adam moves it by
rounding noise on each side, and the next update's eval-mode calls would
carry that noise into its loss.

A BatchNorm's output feeds a (leaky) ReLU. Where one of its outputs in an
update lies within ``chip_smoke.EDU_KINK`` (1e-6) of 0 (a channel whose
BatchNorm scale is near 0, as the N(0, 0.02) init makes some), the two
frameworks may take the kink's two sides: flax's batch variance is
E[x^2] - E[x]^2 and torch's is two-pass, which moves such an output by
about 1e-9. That channel's gradient then differs by one activation's
share, so its BatchNorm weight and bias and its conv's weights and bias
are held to Adam's two-step bound alone in that update
(``chip_smoke._kink_channels``' forward hooks find the channels; the first
such run took a WGAN-GP critic channel at 8.5e-10).

Bounds: the losses (and WGAN-GP's penalty and distance) within 1e-5
relative and 1e-6 absolute; BatchNorm running statistics within 1e-5
relative and 1e-6 absolute; Adam's first moments within 1e-4 of their
module's largest |moment| (the gradient bound of
``tests/test_torch_port_autograd.py``, on (1 - b1) g); the parameters
within 2e-2 of one Adam step (lr) plus 1e-5 relative where a gradient error
of that size moves Adam's step by less than that (lr eps delta / (|g| +
eps)^2 <= 2e-2 lr, delta = 1e-4 of the module's largest |g|), and within
two steps elsewhere, where Adam's step is set by rounding (each side moves
a weight by at most lr an update).
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.data.mnist import synthetic_mnist, to_model_input
from dgm_img_super_resolution_tpu.train.tasks.gan import GANTask as JaxGANTask
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_module_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.train.tasks.gan import GANTask, _draw_fn

from chip_smoke import _kink_channels, _kink_free
from torch_port_helpers import jit_quick

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6
MOMENT_TOL = 1e-4
PARAM_STEP_FRAC, PARAM_RTOL = 2e-2, 1e-5
ADAM_EPS = 1e-8
HP = dict(compute_dtype="float32", crit_repeats=2)
KINDS = ("gan", "dcgan", "wgan-gp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def real_batch(n=4, seed=1):
    return to_model_input(synthetic_mnist(n, seed=seed)[0], 28)


def jax_draws(task: JaxGANTask, rng, n):
    """The draws JAX's ``train_step`` takes from ``rng``, keyed as the port's hook."""
    out = {}
    for k in range(task.crit_repeats):
        rk = jax.random.fold_in(rng, k)
        out[("z", k)] = jax.random.normal(jax.random.fold_in(rk, 0), (n, task.z_dim))
        out[("eps", k)] = jax.random.uniform(jax.random.fold_in(rk, 1), (n, 1, 1, 1))
    out[("z_gen", 0)] = jax.random.normal(jax.random.fold_in(rng, 1000), (n, task.z_dim))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def conv(mod, tree, stats=None):
    return jax_module_params_to_state_dict(mod, jax.device_get(tree), None if stats is None else jax.device_get(stats))


def parts(js, ts):
    return (("gen", ts.gen, ts.gen_opt, js.gen_params, js.gen_stats, js.gen_opt[0]),
            ("disc", ts.disc, ts.disc_opt, js.disc_params, js.disc_stats, js.disc_opt[0]))


def sync(js, ts):
    """Carry a JAX ``GANState`` into the port's: params, BatchNorm
    statistics and each Adam's count and moments."""
    for _, mod, opt, params, stats, adam in parts(js, ts):
        mod.load_state_dict(conv(mod, params, stats), strict=True)
        sd = opt.state_dict()
        count = int(adam.count)
        sd["state"] = {}
        if count:
            mu, nu = conv(mod, adam.mu), conv(mod, adam.nu)
            sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n].clone(),
                               "exp_avg_sq": nu[n].clone()} for i, (n, _) in enumerate(mod.named_parameters())}
        opt.load_state_dict(sd)


def pair(kind):
    jt = JaxGANTask(JHparams(**HP), kind=kind)
    tt = GANTask(Hparams(**HP), kind=kind, device="cpu")
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = tt.init_state(0)
    sync(js, ts)
    return jt, tt, js, ts


def close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def check_state(js_before, js_after, ts, tt, b1, kinks=()):
    """The port's state after one update against JAX's after the same one."""
    for (name, mod, opt, params, stats, adam), (_, _, _, _, _, adam0) in zip(parts(js_after, ts),
                                                                            parts(js_before, ts)):
        want, got = conv(mod, params, stats), mod.state_dict()
        assert set(got) == set(want)
        for key in [k for k in want if "running_" in k]:
            close(got[key], want[key], STAT_RTOL, STAT_ATOL, f"{name}.{key}")
        if int(adam.count) == int(adam0.count):  # not this update's model: untouched
            for key in [k for k in want if "running_" not in k]:
                assert torch.equal(got[key], want[key]), f"{name}.{key}"
            continue
        mu, mu0 = conv(mod, adam.mu), conv(mod, adam0.mu) if int(adam0.count) else None
        grads = {n: (mu[n] - (b1 * mu0[n] if mu0 else 0.0)) / (1.0 - b1) for n in mu}
        delta = 1e-4 * max(float(g.abs().max()) for g in grads.values())
        moments = {n: t["exp_avg"] for n, t in zip(dict(mod.named_parameters()), opt.state_dict()["state"].values())}
        mu_max = max(float(m.abs().max()) for m in mu.values())
        for n, g in grads.items():
            free = _kink_free(name, n, g.shape, kinks).numpy()
            moment_diff = (moments[n] - mu[n]).abs().numpy()
            assert (moment_diff[free] <= MOMENT_TOL * mu_max).all(), f"{name}.{n} first moment: {moment_diff.max()}"
            conditioned = ((g.abs() + ADAM_EPS) ** 2 >= ADAM_EPS * delta / PARAM_STEP_FRAC).numpy() & free
            diff = (got[n] - want[n]).abs().numpy()
            bound = PARAM_STEP_FRAC * tt.lr + PARAM_RTOL * want[n].abs().numpy()
            assert (diff[conditioned] <= bound[conditioned]).all(), f"{name}.{n}: {diff[conditioned].max()}"
            assert (diff <= 2 * tt.lr).all(), f"{name}.{n}: {diff.max()} over two Adam steps"


@pytest.mark.parametrize("kind", KINDS)
def test_one_round_matches_jax(kind):
    jt, tt, js, ts = pair(kind)
    assert tt.crit_repeats == jt.crit_repeats == (2 if kind == "wgan-gp" else 1)
    assert (tt.lr, tt.b1) == ((3e-4, 0.9) if kind == "gan" else (2e-4, 0.5))
    real = real_batch()
    n = real.shape[0]
    rng = jax.random.PRNGKey(4)
    draws = jax_draws(jt, rng, n)

    # the port's train_step is the sequence of its updates, bit for bit
    whole, seq = copy.deepcopy(ts), copy.deepcopy(ts)
    whole, wm = tt.train_step(whole, real, noise=draws)
    draw = _draw_fn(draws, None, tt.device)
    treal = tt._real(real)
    for k in range(tt.crit_repeats):
        tt._disc_update(seq, treal, k, draw)
    tt._gen_update(seq, n, draw)
    for a, b in ((whole.gen, seq.gen), (whole.disc, seq.disc)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert whole.step == 1

    disc_update = jit_quick(jt._disc_update, js, jnp.asarray(real), rng)
    for k in range(jt.crit_repeats):
        sync(js, ts)
        js_next, jl, jextra = disc_update(js, jnp.asarray(real), jax.random.fold_in(rng, k))
        kinks, unhook = _kink_channels(ts)
        tl, textra = tt._disc_update(ts, treal, k, draw)
        unhook()
        close(float(tl), float(jl), LOSS_RTOL, LOSS_ATOL, f"disc_loss {k}")
        assert set(textra) == set(jextra)
        for m in jextra:
            close(float(textra[m]), float(jextra[m]), LOSS_RTOL, LOSS_ATOL, f"{m} {k}")
        check_state(js, js_next, ts, tt, tt.b1, kinks)
        js = js_next
    sync(js, ts)
    js_next, jg = jit_quick(lambda s, r: jt._gen_update(s, n, r), js, rng)(js, jax.random.fold_in(rng, 1000))
    kinks, unhook = _kink_channels(ts)
    tg = tt._gen_update(ts, n, draw)
    unhook()
    close(float(tg), float(jg), LOSS_RTOL, LOSS_ATOL, "gen_loss")
    check_state(js, js_next, ts, tt, tt.b1, kinks)
    assert set(wm) == {"disc_loss", "gen_loss"} | ({"gp", "w_dist"} if kind == "wgan-gp" else set())


@pytest.mark.parametrize("kind", KINDS)
def test_val_step_matches_jax(kind):
    jt, tt, js, ts = pair(kind)
    real = real_batch(seed=2)
    rng = jax.random.PRNGKey(6)
    want = jt.val_step(js, jnp.asarray(real), rng)
    draws = {("z", 0): jax.random.normal(jax.random.fold_in(rng, 0), (4, jt.z_dim)),
             ("eps", 0): jax.random.uniform(jax.random.fold_in(rng, 1), (4, 1, 1, 1))}
    got = tt.val_step(ts, real, noise={k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    for k in want:
        close(float(got[k]), float(want[k]), LOSS_RTOL, LOSS_ATOL, k)


def test_wgan_gp_penalty_reads_the_statistics_from_before_the_update():
    """The penalty's critic call runs in eval mode on the running statistics
    from before the update's two train-mode calls: with the statistics
    poisoned after the first of them, the update's penalty must not move."""
    tt = GANTask(Hparams(**dict(HP, crit_repeats=1)), kind="wgan-gp", device="cpu")
    real = torch.from_numpy(real_batch()).permute(0, 3, 1, 2)
    g = torch.Generator().manual_seed(0)
    draws = {("z", 0): torch.randn(4, 64, generator=g), ("eps", 0): torch.rand(4, 1, 1, 1, generator=g),
             ("z_gen", 0): torch.randn(4, 64, generator=g)}
    s1, s2 = tt.init_state(3), tt.init_state(3)
    _, m1 = tt.train_step(s1, real, noise=draws)
    bn = s2.disc.trunk.bn0
    orig = bn.forward

    def poisoned(x):  # the first train-mode call leaves absurd running statistics behind
        out = orig(x)
        if bn.training:
            bn.running_var.fill_(1e6)
        return out

    bn.forward = poisoned
    _, m2 = tt.train_step(s2, real, noise=draws)
    assert float(m1["gp"]) == float(m2["gp"])


def test_fit_generate_and_model_io(tmp_path):
    task = GANTask(Hparams(**HP), kind="wgan-gp", device="cpu")
    x = real_batch(4, seed=3)
    data = itertools.repeat(x)
    state, results = task.fit(data, epochs=2, steps_per_epoch=1, seed=0, val_iter=data, val_steps=1)
    assert state.step == 2
    assert all(len(results[k]) == 2 for k in ("gen_train_loss", "disc_train_loss", "gen_val_loss",
                                                 "disc_val_loss"))
    assert all(np.isfinite(v) for vs in results.values() for v in vs)
    fake = task.generate(state, 3, generator=torch.Generator().manual_seed(1))
    assert tuple(fake.shape) == (3, 1, 28, 28) and float(fake.abs().max()) <= 1.0
    path = task.save_model_info(state, str(tmp_path))
    assert path.endswith("model_ckpt_steps_2.ckpt")
    loaded = task.load_model_info(str(tmp_path))
    assert loaded.step == 2
    for a, b in ((state.gen, loaded.gen), (state.disc, loaded.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in ((state.gen_opt, loaded.gen_opt), (state.disc_opt, loaded.disc_opt)):
        for pa, pb in zip(a.state_dict()["state"].values(), b.state_dict()["state"].values()):
            assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert task.load_model_info(str(tmp_path / "none")) is None


def test_simple_gan_generates_nchw_images():
    task = GANTask(Hparams(**HP), kind="gan", device="cpu")
    state = task.init_state(1)
    z = torch.randn(2, 64, generator=torch.Generator().manual_seed(2))
    rows = state.gen(z)
    img = task.generate(state, 2, z=z)
    assert tuple(img.shape) == (2, 1, 28, 28)
    # the rows are JAX's NHWC flattening; with one channel NHWC and NCHW agree
    assert torch.equal(img.reshape(2, -1), rows.detach())
