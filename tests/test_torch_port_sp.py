"""Spatial sharding over four ranks of a gloo group on the CPU
(``parallel/mesh.py``'s ``sp`` axis and ``row_split`` under ``inference.py``
and ``train/trainer.py``), against the JAX package on one device and against
the port's own one-process runs; and the serve's routing against JAX's.

One spawn of four ranks (``torch_port_dp_ranks.py``, which imports no JAX)
on mesh ``dp=2,sp=2`` runs every serve case and training step there; the
JAX references and the port's one-process runs are made here.

- Serve: the model of ``test_torch_port_dp_serve.py`` (hidden 8, RRDB nb 3)
  under DDIM, 4 steps of T 8, eta 1. Batch 1 at LR 16 -> 64 splits its rows
  over all four ranks (16 HR rows a rank, 2 at the UNet's deepest stage);
  its float [0, 1] images against JAX's single-device pipeline, fed the same
  JAX key stream, within JAX's own bound of 1e-4, and its uint8 images
  within 1 level (``tests/test_train_parallel.py:244-245``); both against
  the port's one-process serve within ``WORLD1_ATOL``, the dp test's bound
  (a rank's convs run over 16 of the 64 rows, which oneDNN sums in another
  order). The same for the progress path and ``enc_interval`` 2; GroupNorm
  Blocks and linear attention, a batch of 2 (split by rows: 4 ranks do not
  divide it) and a batch of 4 (on dp, replicated over sp) against the
  one-process serve.
- Training: the first update of ``test_torch_port_train_step.py``'s run
  (its tiny stack: clip, EMA, ``use_wn``, no RRDB; its two micro-batches of
  2 of 32² under ``accumulate_grad_batches`` 2 and their JAX draws), the
  batch over dp and the image rows over sp (one image and 16 HR, 4 LR rows
  a rank): the l1 and the ssim loss (its window's 5-row halo), against a
  jitted JAX ``Trainer._step`` on one device and the port's one-process
  steps, at that file's bounds; and the l1 steps drawing their own noise
  against the one-process steps drawing from the same seed. (At a global
  batch of 4 the l1 loss's final 1x1 bias gradient, a sum of +-1/N terms
  that cancel, puts even the one-process port 1.2e-5 to 2.1e-5 of its
  largest from JAX in Adam's second moment, past ``MOMENT_TOL``: so the
  batch is that file's, where the bound was set.)
- The mid attention (``use_attn``) amplifies a rounding difference: its
  pixel softmax moves by |k| times a relative change in k, and a rank's
  convs over its 16 rows round otherwise than over 64. Its serve against
  the one-process serve is held at ``ATTN_WORLD1_ATOL`` (measured 1.06e-4;
  the same serve at 4 intra-op threads against 1 moves by 2.5e-5); that the
  split is exact but for rounding is held in float64 by
  ``test_torch_port_sp_sites.py``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.models.factory import build_srdiff as jax_build_srdiff
from dgm_img_super_resolution_tpu.models.param_transforms import wn_split
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dgm_img_super_resolution_tpu.train.tasks.srdiff import SRDiffTask as JaxTask
from dgm_img_super_resolution_tpu.train.trainer import Trainer as JaxTrainer
from dgm_img_super_resolution_tpu.train.trainer import TrainState as JaxState
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import ChunkNoise, SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.parallel.mesh import Mesh
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer

from test_torch_port_dp_serve import ATOL, TINY, WORLD1_ATOL, lr_batch
from test_torch_port_dp_train import port_state_dict
from test_torch_port_train_losses import jax_draws, make_batch
from test_torch_port_train_step import (
    MOMENT_TOL, PARAM_ALL, PARAM_STEADY, RUN, adam_state, lr_sum, moment_err, param_errs, to_port_names, tree_np,
)
from torch_port_dp_ranks import spawn_ranks
from torch_port_helpers import jax_noise, jit_quick, random_jax_params

SPEC = "dp=2,sp=2"
WORLD = 4
HR = 64  # the batch-1 serve's HR side: LR 16
# name: (hp overrides, LR batch, JAX reference (its enc_interval) or None, as_uint8 too, progress)
SERVE = {
    "b1": ({}, lr_batch(11, (1, 16, 16, 3)), 1, True, False),
    "progress": ({}, lr_batch(11, (1, 16, 16, 3)), 1, False, True),
    "encprop": (dict(enc_interval=2), lr_batch(11, (1, 16, 16, 3)), 2, False, False),
    "gn": (dict(gn_groups=8), lr_batch(12, (1, 16, 16, 3)), None, False, False),
    "attn": (dict(use_attn=True), lr_batch(13, (1, 16, 16, 3)), None, False, False),
    "b2": ({}, lr_batch(14, (2, 16, 16, 3)), None, False, False),
    "b4": ({}, lr_batch(15, (4, 8, 8, 3)), None, False, False),
}
ATTN_WORLD1_ATOL = 2.5e-4
# name: (loss overrides, JAX's draws fed in)
TRAIN = {"l1": (dict(), True), "ssim": (dict(loss_type="ssim"), True), "l1_drawn": (dict(), False)}
B = 2  # the global batch: 1 a dp row, its rows over the two ranks of the dp row's sp group


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(key, n, hr):
    return {(): jax_noise(key, (n, hr, hr, 3), range(TINY["timesteps"]))}


def _world1_serve(sd, hp, lr, noise, seed, progress, uint8):
    pipe = SRDiffPipeline(Hparams(hp), params=sd, device="cpu")
    hook = None if noise is None else ChunkNoise(lambda path, shape: noise[path])
    cb = (lambda d, t: None) if progress else None
    out = {"img": pipe.upscale_batch(lr, generator=torch.Generator().manual_seed(seed), noise=hook, progress_cb=cb,
                                     callback_steps=2)}
    if uint8:
        out["uint8"] = pipe.upscale_batch_device(lr, generator=torch.Generator().manual_seed(seed), noise=hook,
                                                 as_uint8=True).numpy()
    return out


def _jax_steps(hp_kw, params, batches, keys):
    """The jitted JAX ``Trainer._step`` on one device from a fresh state
    through the micro-batches: (the last state, each micro-batch's metrics)."""
    jhp = JHparams(**hp_kw)
    jtr = JaxTrainer(jhp, JaxTask(jhp, jax_build_srdiff(jhp)).loss_fn, init_params_fn=None,
                     mesh=jax_make_mesh("dp=1", devices=jax.devices()[:1]))
    state = JaxState(params=params, opt_state=jax.jit(jtr.tx.init)(params), step=jnp.zeros((), jnp.int32),
                     ema_params=params)
    step, metrics = jit_quick(jtr._step, state, batches[0], keys[0]), []
    for batch, key in zip(batches, keys):
        state, m = step(state, batch, key)
        metrics.append(tree_np(m))
    return state, metrics


def _world1_steps(hp_kw, sd, batches, draws):
    from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff
    from dgm_img_super_resolution_tpu_torch.models.param_transforms import apply_weight_norm

    hp = Hparams(**hp_kw)
    model = build_srdiff(hp)
    apply_weight_norm(model.denoise_fn)
    model.load_state_dict(sd)
    tr = Trainer(hp, SRDiffTask(hp, model).loss_fn, init_params_fn=lambda seed: model, device="cpu",
                 mesh=Mesh({"dp": 1}, 0))
    state, gen, metrics = tr.init_state(), torch.Generator().manual_seed(11), []
    for i, batch in enumerate(batches):
        kw = {} if draws is None else {"t": draws[i][0], "noise": draws[i][1]}
        state, m = tr.train_step(state, batch, gen, **kw)
        metrics.append({k: float(v) for k, v in m.items()})
    adam, named = state.optimizer.adam, list(model.named_parameters())
    return {"metrics": metrics, "step": state.step, "updates": state.optimizer.updates,
            "params": {n: p.detach().clone() for n, p in named},
            "mu": {n: adam.state[p]["exp_avg"].clone() for n, p in named if p in adam.state},
            "nu": {n: adam.state[p]["exp_avg_sq"].clone() for n, p in named if p in adam.state},
            "ema": {n: v.clone() for n, v in state.ema.items()}}


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """(JAX references, the port's one-process results, the ranks' outputs)."""
    jax_out, world1, serve = {}, {}, {}
    params = random_jax_params(JHparams(TINY), 0)[1]
    sd = jax_params_to_state_dict(params)
    key = jax.random.PRNGKey(21)
    for name, (over, lr, jax_k, uint8, progress) in SERVE.items():
        hp = dict(TINY, **over)
        # GroupNorm's and attention's own parameters (the gate nonzero), where the case has them
        own = "gn_groups" in over or "use_attn" in over
        csd = jax_params_to_state_dict(random_jax_params(JHparams(hp), 0)[1]) if own else sd
        noise = _noise(key, lr.shape[0], 4 * lr.shape[1]) if jax_k else None
        if jax_k and jax_k not in jax_out:
            jpipe = JaxPipeline(JHparams(dict(TINY, enc_interval=jax_k)), params=params,
                                mesh=jax_make_mesh("dp=1", devices=jax.devices()[:1]))
            jax_out[jax_k] = np.asarray(jpipe.upscale_batch(lr, rng=key))
        serve[name] = {"hp": hp, "lr": lr, "noise": noise, "uint8": uint8, "progress": progress, "seed": 5,
                       "state_dict": csd}
        world1[name] = _world1_serve(csd, hp, lr, noise, 5, progress, uint8)

    tparams = random_jax_params(JHparams(**RUN), seed=3)[1]
    tparams_wn = {**tparams, "denoise_fn": jax.jit(wn_split)(tparams["denoise_fn"])}
    tsd, names = port_state_dict(tparams_wn)
    batches = [make_batch(seed=10 + i, b=B) for i in range(2)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    draws = [jax_draws(k, B, b["hr"].shape, RUN["timesteps"]) for b, k in zip(batches, keys)]
    train = {}
    for name, (over, jax_fed) in TRAIN.items():
        hp_kw = dict(RUN, **over)
        if jax_fed:
            jax_out[f"train_{name}"] = _jax_steps(hp_kw, tparams_wn, batches, keys)
        world1[f"train_{name}"] = _world1_steps(hp_kw, tsd, batches, draws if jax_fed else None)
        train[name] = {"hp": over, "batches": batches, "draws": draws if jax_fed else None}
    work = tmp_path_factory.mktemp("sp")
    torch.save({"mesh_shape": SPEC, "serve": serve, "train": train, "train_hp": RUN,
                "train_state_dict": tsd, "work": str(work)}, work / "inputs.pt")
    return jax_out, world1, names, spawn_ranks("sp", work, world=WORLD)


def test_ranks_hold_a_dp2_sp2_mesh(sp_run):
    *_, ranks = sp_run
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["backend"] == "gloo" and r["mesh"] == {"dp": 2, "sp": 2} for r in ranks)


@pytest.mark.parametrize("name", ["b1", "progress", "encprop"])
def test_spatial_serve_matches_jax_one_device(sp_run, name):
    """Batch 1 split by rows over four ranks against JAX's single-device
    pipeline (the progress path against JAX's fast path, as JAX's progress
    path runs the same exact chain): float within 1e-4, uint8 within 1."""
    jax_out, _, _, ranks = sp_run
    ref = jax_out[SERVE[name][2]]
    for r in ranks:
        got = r[name]
        assert got["spatial"] and got["img"].shape == ref.shape == (1, HR, HR, 3)
        np.testing.assert_allclose(got["img"], ref, rtol=0, atol=ATOL)
        if "uint8" in got:
            want = np.round(ref * np.float32(255)).astype(np.int16)
            assert np.abs(got["uint8"].astype(np.int16) - want).max() <= 1
    if name == "progress":
        assert all(r[name]["progress"] == [(2, 4), (4, 4)] for r in ranks)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_matches_world1_on_every_rank(sp_run, name):
    """Every rank returns the one-process images (and the spatial paths'
    uint8 within 1 level); the ranks agree to the bit."""
    _, world1, _, ranks = sp_run
    want = world1[name]
    for r in ranks:
        np.testing.assert_allclose(r[name]["img"], want["img"], rtol=0,
                                   atol=ATTN_WORLD1_ATOL if name == "attn" else WORLD1_ATOL)
        if "uint8" in want:
            assert np.abs(r[name]["uint8"].astype(np.int16) - want["uint8"].astype(np.int16)).max() <= 1
        np.testing.assert_array_equal(r[name]["img"], ranks[0][name]["img"])


def test_routing_on_the_mesh(sp_run):
    """Batches of 1 and 2 split by rows over the world (4 does not divide
    them); a batch of 4 shards over dp, with no warning anywhere."""
    *_, ranks = sp_run
    for r in ranks:
        assert all(r[n]["spatial"] for n in ("b1", "progress", "encprop", "gn", "attn", "b2"))
        assert not r["b4"]["spatial"]
        assert not any(r[n]["warnings"] for n in SERVE)


@pytest.mark.parametrize("name", ["l1", "ssim"])
def test_spatial_step_matches_jax_one_device(sp_run, name):
    """Each micro-batch's loss and gradient norm are the global batch's;
    after the update, Adam's moments and the parameters and EMA, on every
    rank, against JAX's steps on one device."""
    jax_out, _, names, ranks = sp_run
    js, jms = jax_out[f"train_{name}"]
    s = lr_sum(RUN, 1)
    mu = dict(to_port_names(adam_state(js.opt_state).mu, names))
    nu = dict(to_port_names(adam_state(js.opt_state).nu, names))
    for r in ranks:
        snap = r[f"train_{name}"]
        for m, jm in zip(snap["metrics"], jms):
            assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
            assert abs(m["grad_norm"] - float(jm["grad_norm"])) <= MOMENT_TOL * float(jm["grad_norm"])
        assert snap["step"] == 2 and snap["updates"] == 1
        assert moment_err(snap["mu"], mu) <= MOMENT_TOL and moment_err(snap["nu"], nu) <= MOMENT_TOL
        for key, jt in (("params", js.params), ("ema", js.ema_params)):
            steady, every = param_errs(snap[key], dict(to_port_names(jt, names)), mu)
            assert steady <= PARAM_STEADY * s and every <= PARAM_ALL * s, (key, steady / s, every / s)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_spatial_step_matches_world1_and_ranks_agree(sp_run, name):
    """Against the port's one-process steps from the same state and draws
    (drawn: from the same seed, the whole image's noise sliced to each
    rank's rows); all four ranks hold the same numbers."""
    _, world1, _, ranks = sp_run
    want = world1[f"train_{name}"]
    s = lr_sum(RUN, 1)
    for r in ranks:
        snap = r[f"train_{name}"]
        assert (snap["step"], snap["updates"]) == (want["step"], want["updates"]) == (2, 1)
        for m, wm in zip(snap["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm"):
                assert abs(m[k] - wm[k]) <= MOMENT_TOL * abs(wm[k]), k
        assert moment_err(snap["mu"], want["mu"]) <= MOMENT_TOL and moment_err(snap["nu"], want["nu"]) <= MOMENT_TOL
        for key in ("params", "ema"):
            steady, every = param_errs(snap[key], want[key], want["mu"])
            assert steady <= PARAM_STEADY * s and every <= PARAM_ALL * s, (key, steady / s, every / s)
        for key in ("params", "mu", "nu", "ema"):
            for n, v in snap[key].items():
                assert torch.equal(v, ranks[0][f"train_{name}"][key][n]), (key, n)


# --------------------------------------------------------------- routing
@pytest.fixture(scope="module")
def pipes():
    """The port's pipeline on a mesh of 8 ranks and of 1 (no group: the
    routing alone, and a serve that does not split)."""
    hp = Hparams(TINY)
    p8 = SRDiffPipeline(hp, device="cpu", mesh=Mesh({"dp": 8}, 0))
    return p8, SRDiffPipeline(hp, params=p8.model.state_dict(), device="cpu", mesh=Mesh({"dp": 1}, 0))


def test_spatial_gate_gives_jaxs_answers(pipes):
    """JAX's ``test_spatial_shardable_gate`` and
    ``test_batch1_routes_spatial_on_multichip_mesh``
    (``tests/test_train_parallel.py:188-216``), case by case."""
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import spatial_shardable

    p8, p1 = pipes
    m8, m1 = p8.mesh, p1.mesh
    assert spatial_shardable(16, m8) and spatial_shardable(128, m8)
    assert not spatial_shardable(8, m8) and not spatial_shardable(12, m8) and not spatial_shardable(128, m1)
    assert p8._spatial_serving(1, 16) and p8._spatial_serving(3, 128)
    assert not p8._spatial_serving(8, 128) and not p8._spatial_serving(1, 12)
    assert not p1._spatial_serving(1, 128)


def test_rows_that_do_not_split_down_the_unet_replicate_with_the_warning(pipes, caplog):
    """LR 24 on 8 ranks passes JAX's rule (3 rows a rank) but each rank's
    12 HR rows do not divide by 2^(stages - 1) = 8: served as today, whole
    on every rank, with a warning naming the reason; the images are the
    one-process ones."""
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import spatial_shardable

    p8, p1 = pipes
    assert spatial_shardable(24, p8.mesh) and not p8._spatial_serving(1, 24)
    lr = lr_batch(16, (1, 24, 24, 3))
    with caplog.at_level(logging.WARNING, logger="dgm_img_super_resolution_tpu_torch"):
        got = p8.upscale_batch(lr, generator=torch.Generator().manual_seed(2))
    msgs = [rec.getMessage() for rec in caplog.records]
    assert any("2^(stages - 1) = 8" in m for m in msgs) and any("replicating" in m for m in msgs)
    np.testing.assert_array_equal(got, p1.upscale_batch(lr, generator=torch.Generator().manual_seed(2)))
