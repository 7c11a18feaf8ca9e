"""One trainer step of the port against a jitted JAX ``Trainer._step``
from the same fresh state, on the CPU; and the UNet's He-normal re-init and
weight norm (``models/param_transforms.py``).

The tiny stack of ``test_torch_port_train_losses.py`` (the same weights on
both sides, the JAX draws fed to the port). One run takes four
micro-batches under ``accumulate_grad_batches`` 2 with the clip active (max
norm 0.5, below every averaged gradient's norm here), ``decay_steps`` 1 (the
second update is past a step-decay boundary, at lr / 2), EMA 0.9 and
``use_wn`` (the optimizer steps the UNet's weight-norm (g, v) pairs),
without the RRDB (``use_rrdb`` false: the condition is the LR image, which
the port's UNet did not take before); the JAX step is compiled once for
the module.

Bounds:
- the micro-batch's ``grad_norm``, Adam's first and second moments: 1e-5
  of their tensor's largest |value| (float32 gradients in another order);
- parameters and EMA, in units of the learning rates applied so far
  (``lr_sum``): an Adam update is lr * m / (sqrt(v) + 1e-8), about +-lr
  whatever the gradient's size, so where the gradient is as small as the
  frameworks' float32 differences its sign, and the update, may flip:
  there the parameters may differ by up to 2 lr_sum (``PARAM_ALL``).
  Where |mu| is at least ``STEADY_MU`` (5%) of its tensor's largest, the
  moments' error (``MOMENT_TOL`` of that largest, carried forward from
  the first update's flipped elements into the next gradients) is at most
  2e-4 of mu and of the update, and the parameters agree within 1e-3
  lr_sum (``PARAM_STEADY``); a wrong clip, learning rate or moment moves
  them by a good part of lr there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.models.factory import build_srdiff as jax_build_srdiff
from dgm_img_super_resolution_tpu.models.param_transforms import wn_merge, wn_split
from dgm_img_super_resolution_tpu.train.tasks.srdiff import SRDiffTask as JaxTask
from dgm_img_super_resolution_tpu.train.trainer import Trainer as JaxTrainer
from dgm_img_super_resolution_tpu.train.trainer import TrainState as JaxState
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.models.param_transforms import apply_weight_norm, remove_weight_norm
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer

from test_torch_port_train_losses import TINY, jax_draws, make_batch, port_model
from torch_port_helpers import jit_quick, random_jax_params

MOMENT_TOL = 1e-5
PARAM_STEADY, PARAM_ALL = 1e-3, 2.0
STEADY_MU = 0.05
RUN = dict(TINY, compute_dtype="float32", clip_grad_norm=0.5, decay_steps=1, accumulate_grad_batches=2,
           ema_decay=0.9, use_wn=True, use_rrdb=False)
PARAMETRIZED = ".parametrizations.weight.original"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def adam_state(opt_state) -> optax.ScaleByAdamState:
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    return next(x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(x))


def to_port_names(tree, names) -> dict:
    """A JAX tree (params, moments, EMA; weight-norm ``{v, g}`` pairs too)
    under the port's parameter ``names``: ``original0`` is g, ``original1`` v."""
    is_vg = lambda x: isinstance(x, dict) and set(x) == {"v", "g"}  # noqa: E731
    part = {k: jax_params_to_state_dict(jax.tree_util.tree_map(lambda x: x[k] if is_vg(x) else x, tree_np(tree),
                                                               is_leaf=is_vg)) for k in "vg"}
    out = {}
    for n in names:
        if PARAMETRIZED in n:
            base = n.split(PARAMETRIZED)[0] + ".weight"
            out[n] = part["g" if n.endswith("0") else "v"][base]
        else:
            out[n] = part["v"][n]
    return out


def run_both(hp_kw, params, n_steps, tmp_path_factory):
    """Both trainers from one fresh state (the JAX tree ``params``) through
    ``n_steps`` micro-batches of the same batches and draws; per step (JAX
    state, JAX metrics, port snapshot)."""
    jhp, hp = JHparams(**hp_kw), Hparams(**hp_kw)
    d = jax_build_srdiff(jhp)
    jtask = JaxTask(jhp, d)
    if jhp["use_wn"]:
        params = {**params, "denoise_fn": jax.jit(wn_split)(params["denoise_fn"])}
    jtr = JaxTrainer(jhp, jtask.loss_fn, init_params_fn=None)
    ema = params if jtr.ema_decay > 0 else None
    jstate = JaxState(params=params, opt_state=jax.jit(jtr.tx.init)(params), step=jnp.zeros((), jnp.int32),
                      ema_params=ema)

    plain = {**params, "denoise_fn": jax.jit(wn_merge)(params["denoise_fn"])} if hp["use_wn"] else params
    model = port_model(hp, tree_np(plain))
    if hp["use_wn"]:
        apply_weight_norm(model.denoise_fn)
        # (g, v) exactly the JAX pair, not the split of the merged kernel
        with torch.no_grad():
            src = to_port_names(params, [n for n, _ in model.named_parameters()])
            for n, p in model.named_parameters():
                p.copy_(src[n])
    task = SRDiffTask(hp, model)
    tr = Trainer(hp, task.loss_fn, init_params_fn=lambda seed: model, device="cpu",
                 work_dir=str(tmp_path_factory.mktemp("work")))
    state = tr.init_state()
    names = [n for n, _ in model.named_parameters()]
    step_fn, out = None, []
    for i in range(n_steps):
        batch = make_batch(seed=10 + i)
        key = jax.random.PRNGKey(100 + i)
        if step_fn is None:
            step_fn = jit_quick(jtr._step, jstate, batch, key)
        jstate, jm = step_fn(jstate, batch, key)
        t, noise = jax_draws(key, 2, batch["hr"].shape, 100)
        state, m = tr.train_step(state, batch, t=t, noise=noise)
        adam = state.optimizer.adam
        snap = {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                "mu": {n: adam.state[p]["exp_avg"].clone() for n, p in model.named_parameters() if p in adam.state},
                "nu": {n: adam.state[p]["exp_avg_sq"].clone() for n, p in model.named_parameters()
                       if p in adam.state},
                "ema": None if state.ema is None else {n: v.clone() for n, v in state.ema.items()},
                "metrics": {k: float(v) for k, v in m.items()}, "step": state.step,
                "updates": state.optimizer.updates, "lr_sum": None}
        out.append((jstate, tree_np(jm), snap))
    return names, out


def lr_sum(hp_kw, updates):
    return sum(hp_kw.get("lr", 2e-4) * 0.5 ** (u // hp_kw.get("decay_steps", 200000)) for u in range(updates))


def moment_err(got: dict, want: dict) -> float:
    """The largest error of a moment over its tensor's largest |value|; a
    parameter without a gradient (the fixed RRDB's) has no Adam state in
    torch and zero moments in optax."""
    err = 0.0
    for n, w in want.items():
        if n not in got:
            assert not w.any(), n
            continue
        err = max(err, float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return err


def param_errs(got: dict, want: dict, mu: dict) -> tuple[float, float]:
    """(max |got - want| where |mu| >= STEADY_MU of its tensor's max,
    max |got - want|)."""
    steady = every = 0.0
    for n, w in want.items():
        d = (got[n] - w).abs()
        every = max(every, float(d.max()))
        m = mu[n].abs()
        mask = m >= STEADY_MU * m.max()
        if bool(mask.any()):
            steady = max(steady, float(d[mask].max()))
    return steady, every


@pytest.fixture(scope="module")
def jax_params():
    return random_jax_params(JHparams(**RUN), seed=3)[1]


@pytest.fixture(scope="module")
def run_a(jax_params, tmp_path_factory):
    return run_both(RUN, jax_params, 4, tmp_path_factory)


def test_steps_and_counts_under_accumulation(run_a):
    """``state.step`` counts micro-batches; Adam's count and the schedule's
    advance once per applied update; a held micro-step leaves the
    parameters as they were, bit for bit."""
    names, out = run_a
    prev = None
    for i, (js, _, snap) in enumerate(out):
        adam = adam_state(js.opt_state)
        assert snap["step"] == int(js.step) == i + 1
        assert snap["updates"] == int(adam.count) == int(js.opt_state.gradient_step) == (i + 1) // 2
        if i % 2 == 0:
            before = prev if prev is not None else None
            if before is not None:
                assert all(torch.equal(snap["params"][n], before[n]) for n in names)
        prev = snap["params"]


def test_grad_norm_and_adam_moments_match_jax(run_a):
    names, out = run_a
    for i, (js, jm, snap) in enumerate(out):
        assert abs(snap["metrics"]["grad_norm"] - float(jm["grad_norm"])) <= MOMENT_TOL * float(jm["grad_norm"])
        assert abs(snap["metrics"]["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        if (i + 1) % 2:
            continue  # the update is held: no moments yet, or the last update's
        adam = adam_state(js.opt_state)
        for key, jt in (("mu", adam.mu), ("nu", adam.nu)):
            want = dict(to_port_names(jt, names))
            assert moment_err(snap[key], want) <= MOMENT_TOL, (i, key)


def test_clip_is_active_on_the_averaged_gradient(run_a):
    """After the first update mu = 0.1 * the clipped average: its global
    norm is 0.1 * max_norm on both sides, where the micro-batches' own
    gradients were larger."""
    _, out = run_a
    js, jm, snap = out[1]
    mu_norm = float(np.sqrt(sum(np.sum(np.square(v)) for v in jax.tree_util.tree_leaves(
        tree_np(adam_state(js.opt_state).mu)))))
    assert abs(mu_norm - 0.1 * RUN["clip_grad_norm"]) <= 1e-5
    port = float(torch.linalg.vector_norm(torch.stack([v.norm() for v in snap["mu"].values()])))
    assert abs(port - 0.1 * RUN["clip_grad_norm"]) <= 1e-5
    assert min(s["metrics"]["grad_norm"] for _, _, s in out[:2]) > RUN["clip_grad_norm"]


@pytest.mark.parametrize("update", [1, 2], ids=["first_update", "past_the_decay_boundary"])
def test_parameters_and_ema_match_jax(run_a, update):
    """After the first update (lr) and the second (lr / 2: decay_steps 1),
    the parameters and the EMA (moved at all four micro-steps)."""
    names, out = run_a
    js, _, snap = out[2 * update - 1]
    s = lr_sum(RUN, update)
    mu = dict(to_port_names(adam_state(js.opt_state).mu, names))
    for key, jt in (("params", js.params), ("ema", js.ema_params)):
        want = dict(to_port_names(jt, names))
        steady, every = param_errs(snap[key], want, mu)
        assert steady <= PARAM_STEADY * s and every <= PARAM_ALL * s, (key, steady / s, every / s)
    # the second update moved steady parameters by about lr / 2, not lr
    if update == 2:
        prev = out[1][2]["params"]
        moved = max(float((snap["params"][n] - prev[n]).abs().max()) for n in names)
        assert 0.45 * 2e-4 <= moved <= 0.6 * 2e-4


def test_weight_norm_pairs_are_what_the_optimizer_steps(run_a):
    """``use_wn``: every UNet conv / ConvT / linear weight is a (g, v) pair
    with its own moments; the merged kernels after both updates match JAX's ``wn_merge`` of its
    pairs, each part of a pair moving by at most PARAM_ALL * lr_sum."""
    names, out = run_a
    js, _, snap = out[3]
    wn = [n for n in names if PARAMETRIZED in n]
    assert len(wn) > 20 and all(n in snap["mu"] for n in wn)
    plain = sorted({n.split(PARAMETRIZED)[0] + ".weight" for n in wn})
    model = build_srdiff(Hparams(**RUN))
    apply_weight_norm(model.denoise_fn)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(snap["params"][n])
    remove_weight_norm(model.denoise_fn)
    got = dict(model.state_dict())
    want = jax_params_to_state_dict(tree_np({**js.params, "denoise_fn": jax.jit(wn_merge)(js.params["denoise_fn"])}))
    worst = max(float((got[n] - want[n]).abs().max()) for n in plain)
    assert worst <= 2 * PARAM_ALL * lr_sum(RUN, 2)


# ---------------------------------------------------------------- transforms
def test_kaiming_init_statistics_and_shapes():
    """``weight_init``: every UNet conv / ConvT / linear weight redrawn
    with std sqrt(2 / fan_in), every UNet bias 0, the RRDB untouched."""
    hp = Hparams(**TINY, compute_dtype="float32")
    ref = init_srdiff_params(build_srdiff(hp), seed=5)
    m = init_srdiff_params(build_srdiff(hp), seed=5, weight_init=True)
    for (n, p), (_, q) in zip(m.named_parameters(), ref.named_parameters()):
        assert p.shape == q.shape
        if n.startswith("rrdb."):
            assert torch.equal(p, q), n
        elif n.endswith(".bias"):
            assert not p.any(), n
    for mod in m.denoise_fn.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and mod.weight.numel() >= 2000:
            w = mod.weight
            fan = w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose2d) else w[0].numel()
            assert abs(float(w.std()) / np.sqrt(2.0 / fan) - 1) < 0.1
            assert abs(float(w.mean())) < 0.1 * np.sqrt(2.0 / fan)


def test_weight_norm_shapes_and_merge_round_trip(jax_params):
    """(g, v) per layer type, the merged weights equal JAX's ``wn_merge``
    of ``wn_split`` on the same kernels, and ``remove_weight_norm`` gives
    them back as plain weights."""
    params = jax_params
    m = port_model(Hparams(**RUN), params)
    ref = {n: p.detach().clone() for n, p in m.named_parameters()}
    apply_weight_norm(m.denoise_fn)
    for mod in m.denoise_fn.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            g, v = mod.parametrizations.weight.original0, mod.parametrizations.weight.original1
            o = 1 if isinstance(mod, nn.ConvTranspose2d) else 0
            assert g.shape == tuple(s if a == o else 1 for a, s in enumerate(v.shape))
    wn_round = jax.jit(lambda p: wn_merge(wn_split(p)))
    merged = jax_params_to_state_dict(tree_np({**params, "denoise_fn": wn_round(params["denoise_fn"])}))
    remove_weight_norm(m.denoise_fn)
    for n, p in m.named_parameters():
        assert float((p - merged[n]).abs().max()) <= 1e-6 * float(merged[n].abs().max()), n
        assert float((p - ref[n]).abs().max()) <= 1e-6 * float(ref[n].abs().max()), n


def test_jax_params_carry_a_flipped_size_one_axis():
    """A ConvTranspose kernel with a 1x1 window (a weight-norm gain has that
    shape) is flipped on size-1 axes; the carried tensor must still have
    positive strides (``ckpt/jax_params.py`` used to hand torch a negative
    one and raise)."""
    g = np.arange(6, dtype=np.float32).reshape(1, 1, 2, 3)
    sd = jax_params_to_state_dict({"denoise_fn": {"cond_proj": {"kernel": g}}})
    assert torch.equal(sd["denoise_fn.cond_proj.weight"], torch.from_numpy(np.transpose(g, (2, 3, 0, 1)).copy()))
