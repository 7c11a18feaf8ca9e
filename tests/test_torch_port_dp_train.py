"""The trainer over two ranks of a gloo group on the CPU
(``parallel/mesh.py`` under ``train/trainer.py``, its tasks and the
loader) against the JAX package's ``Trainer`` on a dp=2 mesh and against
the port's own one-process step.

One spawn of two ranks (``torch_port_dp_ranks.py``, which imports no JAX)
runs every check there; the JAX references and the port's one-process
runs are made here.

- The tiny stack of ``test_torch_port_train_step.py`` (clip, a decay
  boundary, EMA, ``use_wn``, no RRDB) over global batches of 4, 2 a rank:
  two micro-batches under ``accumulate_grad_batches`` 2, one update, with
  JAX's draws over the global batch fed to both; that file's bounds. Rank
  1 starts from zeroed weights, which ``init_state`` replaces with rank 0's.
- Rank 0 alone writes the checkpoint; both ranks resume from it; ``fit``
  logs and saves once, and resumes on both ranks.
- One ``DDPMTask`` step from a seeded generator: the draws for the global
  batch, sliced, so world 2 takes the one-process step (loss and grad norm
  within 1e-5 of theirs, the parameters and moments at the train-step
  file's bounds over the model's scale).
- The loader's rows of each global batch, ``reduce_metrics`` and the
  collectives; ``sp`` builds, another axis > 1 raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.models.factory import build_srdiff as jax_build_srdiff
from dgm_img_super_resolution_tpu.models.param_transforms import wn_merge, wn_split
from dgm_img_super_resolution_tpu.parallel.mesh import batch_spec, make_mesh as jax_make_mesh
from dgm_img_super_resolution_tpu.parallel.mesh import replicate as jax_replicate
from dgm_img_super_resolution_tpu.parallel.mesh import replicated_spec, shard_batch as jax_shard_batch
from dgm_img_super_resolution_tpu.train.tasks.srdiff import SRDiffTask as JaxTask
from dgm_img_super_resolution_tpu.train.trainer import Trainer as JaxTrainer
from dgm_img_super_resolution_tpu.train.trainer import TrainState as JaxState
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.data.loader import DataLoader
from dgm_img_super_resolution_tpu_torch.models.param_transforms import apply_weight_norm
from dgm_img_super_resolution_tpu_torch.train.tasks.vae import DDPMTask

from test_torch_port_train_losses import jax_draws, make_batch, port_model
from test_torch_port_train_step import (
    MOMENT_TOL, PARAM_ALL, PARAM_STEADY, RUN, STEADY_MU, adam_state, lr_sum, moment_err, param_errs, to_port_names,
    tree_np,
)
from torch_port_dp_ranks import spawn_ranks
from torch_port_helpers import random_jax_params

B = 4  # the global batch: 2 a rank
DDPM_HP = dict(ddpm_dim=8, ddpm_timesteps=4)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_dp2_steps(params, batches, keys):
    """The JAX ``Trainer`` on a dp=2 mesh from ``params`` through the
    micro-batches: (state, metrics) after each, its step compiled once."""
    jhp = JHparams(**RUN)
    params = {**params, "denoise_fn": jax.jit(wn_split)(params["denoise_fn"])}
    mesh = jax_make_mesh("dp=2", devices=jax.devices()[:2])
    jtr = JaxTrainer(jhp, JaxTask(jhp, jax_build_srdiff(jhp)).loss_fn, init_params_fn=None, mesh=mesh)
    state = jax_replicate(JaxState(params=params, opt_state=jax.jit(jtr.tx.init)(params),
                                   step=jnp.zeros((), jnp.int32), ema_params=params), mesh)
    rep = replicated_spec(mesh)
    step, out = None, []
    for batch, key in zip(batches, keys):
        sharded = jax_shard_batch(batch, mesh)
        if step is None:
            step = jax.jit(jtr._step, in_shardings=(rep, batch_spec(mesh), rep),
                           out_shardings=(rep, rep)).lower(state, sharded, key).compile(FAST)
        state, m = step(state, sharded, key)
        out.append((state, tree_np(m)))
    return params, out


def port_state_dict(params_wn):
    """The port's SRDiff under weight norm with JAX's (g, v) pairs."""
    hp = Hparams(**RUN)
    plain = {**params_wn, "denoise_fn": jax.jit(wn_merge)(params_wn["denoise_fn"])}
    model = port_model(hp, tree_np(plain))
    apply_weight_norm(model.denoise_fn)
    with torch.no_grad():
        src = to_port_names(params_wn, [n for n, _ in model.named_parameters()])
        for n, p in model.named_parameters():
            p.copy_(src[n])
    return model.state_dict(), [n for n, _ in model.named_parameters()]


def ddpm_world1(x):
    """One ``DDPMTask`` step in one process (one intra-op thread, as a rank)."""
    task = DDPMTask(Hparams(**DDPM_HP), img_hw=8, device="cpu")
    tr = task.make_trainer()
    state, m = tr.train_step(tr.init_state(0), {"x": x}, torch.Generator().manual_seed(5))
    adam = state.optimizer.adam
    named = list(state.model.named_parameters())
    return ({k: float(v) for k, v in m.items()}, {n: p.detach().clone() for n, p in named},
            {n: adam.state[p]["exp_avg"].clone() for n, p in named})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    params = random_jax_params(JHparams(**RUN), seed=3)[1]
    batches = [make_batch(seed=20 + i, b=B) for i in range(2)]
    keys = [jax.random.PRNGKey(200 + i) for i in range(2)]
    params_wn, jax_out = jax_dp2_steps(params, batches, keys)
    sd, names = port_state_dict(params_wn)
    draws = [jax_draws(k, B, b["hr"].shape, RUN["timesteps"]) for b, k in zip(batches, keys)]
    ddpm_x = np.random.default_rng(9).uniform(-1, 1, (B, 8, 8, 1)).astype(np.float32)
    work = tmp_path_factory.mktemp("dp_train")
    torch.save({"hp": RUN, "state_dict": sd, "batches": batches, "draws": draws, "work": str(work),
                "ddpm_hp": DDPM_HP, "ddpm_x": ddpm_x}, work / "inputs.pt")
    ranks = spawn_ranks("train", work)
    return names, jax_out, ddpm_world1(ddpm_x), ranks


def test_ranks_join_a_gloo_group(trained):
    *_, ranks = trained
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" and r["mesh"] == {"dp": 2} for r in ranks)


@pytest.mark.parametrize("micro", [0, 1], ids=["held", "applied"])
def test_loss_and_grad_norm_match_jax_dp2(trained, micro):
    """Each micro-batch's loss and gradient norm are the global batch's, on
    both ranks, as the JAX dp=2 step's."""
    _, jax_out, _, ranks = trained
    jm = jax_out[micro][1]
    for r in ranks:
        m = r["steps"][micro]["metrics"]
        assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(m["grad_norm"] - float(jm["grad_norm"])) <= MOMENT_TOL * float(jm["grad_norm"])
    assert ranks[0]["steps"][micro]["metrics"] == ranks[1]["steps"][micro]["metrics"]


def test_update_matches_jax_dp2_and_ranks_agree(trained):
    """After the update: Adam's moments within ``MOMENT_TOL``, the
    parameters and the EMA in ``lr_sum`` units, as the one-process test's;
    the two ranks hold the same numbers with no broadcast."""
    names, jax_out, _, ranks = trained
    js, _ = jax_out[1]
    s = lr_sum(RUN, 1)
    mu = dict(to_port_names(adam_state(js.opt_state).mu, names))
    nu = dict(to_port_names(adam_state(js.opt_state).nu, names))
    for r in ranks:
        snap = r["steps"][1]
        assert snap["step"] == 2 and snap["updates"] == 1
        assert moment_err(snap["mu"], mu) <= MOMENT_TOL and moment_err(snap["nu"], nu) <= MOMENT_TOL
        for key, jt in (("params", js.params), ("ema", js.ema_params)):
            steady, every = param_errs(snap[key], dict(to_port_names(jt, names)), mu)
            assert steady <= PARAM_STEADY * s and every <= PARAM_ALL * s, (key, steady / s, every / s)
    for key in ("params", "mu", "nu", "ema"):
        for n, v in ranks[0]["steps"][1][key].items():
            assert torch.equal(v, ranks[1]["steps"][1][key][n]), (key, n)


def test_held_micro_batch_leaves_rank1_on_rank0s_weights(trained):
    """Rank 1 began from zeros: after ``init_state`` and a held micro-step
    its parameters are rank 0's, which are JAX's."""
    names, jax_out, _, ranks = trained
    want = dict(to_port_names(jax_out[0][0].params, names))
    for r in ranks:
        for n, v in r["steps"][0]["params"].items():
            assert torch.equal(v, torch.as_tensor(want[n])), n


def test_rank0_writes_the_checkpoint_and_both_resume(trained):
    """Rank 1 resumes through ``load_latest`` from a work dir that holds no
    checkpoint: rank 0 reads its own and broadcasts it."""
    *_, ranks = trained
    for r in ranks:
        assert r["ckpts"] == ["model_ckpt_steps_2.ckpt"]
        res, last = r["resumed"], r["steps"][1]
        assert res["step"] == 2 and res["updates"] == 1
        for key in ("params", "mu", "nu", "ema"):
            assert all(torch.equal(v, last[key][n]) for n, v in res[key].items()), key


def test_fit_logs_and_saves_once_and_resumes_on_every_rank(trained):
    *_, ranks = trained
    for r in ranks:
        assert "model_ckpt_steps_2.ckpt" in r["fit_files"] and "metrics.jsonl" in r["fit_files"]
        assert r["fit_log_lines"] == 2  # rank 0's two lines, not four
        assert "model_ckpt_steps_3.ckpt" in r["fit_files_after_resume"]
    assert ranks[0]["fit_files"] == ranks[1]["fit_files"]
    assert "| resumed from step 2" in ranks[0]["log"] and "resumed" not in ranks[1]["log"]


def test_ddpm_step_at_world2_matches_world1(trained):
    """The conv biases ahead of a GroupNorm have a zero gradient, which
    float32 leaves at 1e-8 of either sign: their first Adam update, +-lr,
    may flip with the world. So the scale is the whole model's, not each
    tensor's: the parameters are held at ``PARAM_STEADY`` where |mu| is at
    least ``STEADY_MU`` of the model's largest |mu|, at ``PARAM_ALL``
    everywhere, and mu within ``MOMENT_TOL`` of that largest."""
    _, _, (m1, p1, mu1), ranks = trained
    top = max(float(m.abs().max()) for m in mu1.values())
    s = lr_sum({}, 1)
    for r in ranks:
        d = r["ddpm"]
        for k in ("loss", "grad_norm"):
            assert abs(d["metrics"][k] - m1[k]) <= 1e-5 * abs(m1[k]), k
        steady = every = 0.0
        for n, w in p1.items():
            diff = (d["params"][n] - w).abs()
            every = max(every, float(diff.max()))
            mask = mu1[n].abs() >= STEADY_MU * top
            if bool(mask.any()):
                steady = max(steady, float(diff[mask].max()))
        assert steady <= PARAM_STEADY * s and every <= PARAM_ALL * s, (steady / s, every / s)
        # the first moment, 0.1 of the gradient, within MOMENT_TOL of the model's largest
        assert max(float((d["mu"][n] - m).abs().max()) for n, m in mu1.items()) <= MOMENT_TOL * top


def test_loader_loads_each_ranks_rows_of_the_global_batch(trained):
    """Both ranks walk one epoch permutation; each loads its half of every
    global batch, on 4 // 2 threads."""
    *_, ranks = trained

    class Items:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return {"i": np.array([i]), "x": np.full((2, 2, 1), float(i), np.float32)}

    whole = [b["i"][:, 0].tolist() for b in DataLoader(Items(), batch_size=4, seed=3, num_workers=4)]
    assert len(whole) == 3
    for r in ranks:
        assert r["loader"]["num_workers"] == 2
        got = r["loader"]["shards"]
        assert [tuple(rows) for rows, _ in got] == [(2 * r["rank"], 2 * r["rank"] + 2, 4)] * 3
        assert [idx for _, idx in got] == [w[2 * r["rank"]: 2 * r["rank"] + 2] for w in whole]


def test_collectives_and_reduce_metrics(trained):
    *_, ranks = trained
    for r in ranks:
        assert torch.equal(r["gather"], torch.arange(12.0).reshape(4, 3))
        assert torch.equal(r["mean"], torch.arange(8.0).reshape(4, 2) + 50)
        assert torch.equal(r["replicated"], torch.arange(8.0).reshape(4, 2))
        red = r["reduced"]
        assert float(red["loss"]) == 1.5 and red["loss"].dtype == torch.float32
        assert red["n"] == 1.0 and isinstance(red["n"], float)
        assert torch.equal(red["v"], torch.tensor([1.5, 4.5])) and red["name"] == "x"


def test_spatial_axis_raises_on_two_ranks(trained):
    """``sp`` builds on two ranks (its group is the world's); another axis
    raises, naming the ROADMAP."""
    *_, ranks = trained
    for r in ranks:
        assert r["sp_mesh"] == ({"dp": 1, "sp": 2}, r["rank"], True)
        assert r["sp_error"] is not None and "tp" in r["sp_error"] and "ROADMAP" in r["sp_error"]
