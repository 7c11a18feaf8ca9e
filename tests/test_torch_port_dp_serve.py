"""The SRDiff serve over two ranks of a gloo group on the CPU
(``parallel/mesh.py`` under ``inference.py``) against the JAX package's
pipeline on a dp=2 mesh and against the port's own one-process serve.

One spawn of two ranks (``torch_port_dp_ranks.py``, which imports no JAX)
serves every case; the JAX pipeline (two of the suite's eight virtual CPU
devices) and the port's one-process pipeline run here. The model is the
serving tests' (hidden 8, RRDB nb 3) under DDIM: 4 steps of T 8, eta 1.
Both pipelines take the same weights and the JAX key stream, fed to the
port call by call through a ``ChunkNoise`` at each call's global batch
shape, as JAX draws it.

Bounds: JAX's own dp bound, 1e-4 absolute on the float [0, 1] output,
against the JAX pipeline (measured up to 5.9e-5). Against the port's
one-process serve, run here with one intra-op thread as each rank: the
noise of a row does not depend on the world, so a replicated batch gives
the same numbers to the bit; a sharded batch's rows ride in a batch of
half the size, whose float32 convolutions oneDNN sums in another order
(measured up to 2.8e-5 after the 4 steps; ``WORLD1_ATOL`` 5e-5).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import ChunkNoise, SRDiffPipeline

from torch_port_dp_ranks import spawn_ranks
from torch_port_helpers import jax_noise, random_jax_params

TINY = dict(compute_dtype="float32", hidden_size=8, rrdb_num_block=3, rrdb_num_feat=8, timesteps=8,
            sampler="ddim", sample_timesteps=4, ddim_eta=1.0)
ATOL = 1e-4
WORLD1_ATOL = 5e-5
ONE = 32 * 32  # the HR pixels of one 8x8 LR image
# the cases whose calls do not depend on the world (a budget splits a batch
# by the world, and each sub-batch takes its own noise)
WORLD1 = ["batch_4", "batch_3", "progress", "tiles"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lr_batch(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def noise_paths(key, paths_and_n, hw=(32, 32)):
    """The JAX key stream, folded along each chunk path, at the call's batch."""
    out = {}
    for path, n in paths_and_n:
        k = key
        for i in path:
            k = jax.random.fold_in(k, i)
        out[path] = jax_noise(k, (n, *hw, 3), range(TINY["timesteps"]))
    return out


# name: (hp overrides, LR batch, the calls' batch sizes at world 2 and JAX dp=2,
# noise paths, JAX key). Every sampler call is of 4 images (2 a rank), so the
# JAX pipeline compiles one program.
CASES = {
    "batch_4": (dict(), lr_batch(1, (4, 8, 8, 3)), [4], [((), 4)], 3),
    # one card's budget is two images: 8 images shard, so two cards' budgets
    # hold 4 a call, in sub-batches sized a multiple of the world
    "budget_shards": (dict(max_native_hr_pixels=2 * ONE), lr_batch(2, (8, 8, 8, 3)), [8, 4, 4],
                      [((0,), 4), ((1,), 4)], 4),
    # 5 images do not shard over 2: budgeted per card, then 4 a call (the last padded)
    "budget_replicates": (dict(max_native_hr_pixels=2 * ONE), lr_batch(3, (5, 8, 8, 3)), [5, 4, 4],
                          [((0,), 4), ((1,), 4)], 5),
    # 4 images shard within two cards' budgets (one process would split them): one call
    "budget_fits_two_cards": (dict(max_native_hr_pixels=2 * ONE), lr_batch(4, (4, 8, 8, 3)), [4], [((), 4)], 6),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX dp=2 images and calls, the port's one-process images, the
    ranks' outputs)."""
    params = random_jax_params(JHparams(TINY), 0)[1]
    sd = jax_params_to_state_dict(params)
    mesh2 = jax_make_mesh("dp=2", devices=jax.devices()[:2])
    jpipe = JaxPipeline(JHparams(TINY), params=params, mesh=mesh2)
    calls = []
    orig = JaxPipeline.upscale_batch_device

    def spy(self, imgs, *a, **k):
        calls.append(int(np.asarray(imgs).shape[0]))
        return orig(self, imgs, *a, **k)

    jax_out, cases, world1 = {}, {}, {}
    JaxPipeline.upscale_batch_device = spy
    try:
        for name, (over, lr, _, paths, seed) in CASES.items():
            calls.clear()
            jpipe.hp = JHparams(dict(TINY, **over))
            key = jax.random.PRNGKey(seed)
            jax_out[name] = (np.asarray(jpipe.upscale_batch(lr, rng=key)), list(calls))
            cases[name] = {"hp": dict(TINY, **over), "lr": lr, "noise": noise_paths(key, paths)}
    finally:
        JaxPipeline.upscale_batch_device = orig
    # port-only cases: a batch the world does not divide, with no budget, at 5 LR rows,
    # which do not split over the ranks either (JAX's rule; 8 rows would split,
    # test_torch_port_sp.py); the progress path; tiles of one image as a batch
    cases["batch_3"] = {"hp": TINY, "lr": lr_batch(5, (3, 5, 8, 3)), "noise": None, "seed": 7}
    cases["progress"] = {"hp": TINY, "lr": CASES["batch_4"][1], "noise": cases["batch_4"]["noise"],
                         "progress": True}
    cases["tiles"] = {"hp": TINY, "lr": lr_batch(6, (16, 24, 3)), "noise": None, "seed": 8,
                      "large": {"patch": 8, "overlap": 2}}
    for name in WORLD1:  # on one intra-op thread, as each rank: oneDNN's float32 sums follow the count
        case = cases[name]
        pipe = SRDiffPipeline(Hparams(case["hp"]), params=sd, device="cpu")
        noise = None if case["noise"] is None else ChunkNoise(lambda path, shape, _n=case["noise"]: _n[path])
        gen = torch.Generator().manual_seed(case.get("seed", 0))
        if case.get("large"):
            world1[name] = pipe.upscale_large(case["lr"], generator=gen, noise=noise, **case["large"])
        else:
            world1[name] = pipe.upscale_batch(case["lr"], generator=gen, noise=noise)
    work = tmp_path_factory.mktemp("dp_serve")
    torch.save({"cases": cases, "state_dict": sd}, work / "inputs.pt")
    return jax_out, world1, spawn_ranks("serve", work)


def test_ranks_join_a_gloo_group_and_a_dp2_mesh(served):
    *_, ranks = served
    for r in ranks:
        assert r["backend"] == "gloo"
        for name in list(CASES) + ["batch_3", "progress", "tiles"]:
            assert r[name]["mesh"] == {"dp": 2} and r[name]["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(CASES))
def test_world2_serve_matches_jax_dp2(served, name):
    """The gathered images on both ranks against the JAX pipeline on a dp=2
    mesh, and the calls each pipeline made: JAX's budget rules at world 2."""
    jax_out, _, ranks = served
    ref, jcalls = jax_out[name]
    assert jcalls == CASES[name][2]
    for r in ranks:
        got = r[name]
        assert got["calls"] == jcalls
        assert got["img"].shape == ref.shape
        np.testing.assert_allclose(got["img"], ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", WORLD1)
def test_world2_serve_matches_world1(served, name):
    """Both ranks return the one-process serve's images, to the bit."""
    _, world1, ranks = served
    for r in ranks:
        np.testing.assert_allclose(r[name]["img"], world1[name], rtol=0, atol=WORLD1_ATOL)
    np.testing.assert_array_equal(ranks[0][name]["img"], ranks[1][name]["img"])


def test_noise_hook_sees_the_global_batch(served):
    """``ChunkNoise`` is asked for each call's global batch shape on every
    rank, as JAX draws it."""
    *_, ranks = served
    for r in ranks:
        assert r["batch_4"]["noise_shapes"] == [((), (4, 3, 32, 32))]
        assert r["budget_shards"]["noise_shapes"] == [((0,), (4, 3, 32, 32)), ((1,), (4, 3, 32, 32))]


def test_indivisible_batch_is_replicated_with_the_warning(served):
    """A batch of 3 on 2 ranks, whose 5 LR rows do not split evenly either:
    served whole on each, with JAX's warning, giving the one-process images
    to the bit; a batch of 4 shards without one."""
    _, world1, ranks = served
    for r in ranks:
        np.testing.assert_array_equal(r["batch_3"]["img"], world1["batch_3"])
        assert r["batch_3"]["calls"] == [3]
        assert any("replicating" in m for m in r["batch_3"]["warnings"])
        assert not r["batch_4"]["warnings"]


def test_progress_fires_on_every_rank(served):
    *_, ranks = served
    for r in ranks:
        assert r["progress"]["progress"] == [(d, 4) for d in range(1, 5)]
        np.testing.assert_array_equal(r["progress"]["img"], r["batch_4"]["img"])


def test_tiles_shard_as_a_batch(served):
    """One 16x24 image in 12 tiles of 8 (overlap 2): one call of 12, 6 a
    rank; the stitched image is the one-process one (above)."""
    *_, ranks = served
    for r in ranks:
        assert r["tiles"]["calls"] == [12]
        assert r["tiles"]["img"].shape == (64, 96, 3)
        assert not r["tiles"]["warnings"]


def test_single_process_serve_is_unchanged(caplog):
    """Without a process group the mesh is dp=1 and no warning is logged."""
    from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff

    sd = build_srdiff(Hparams(TINY)).state_dict()
    with caplog.at_level(logging.WARNING, logger="dgm_img_super_resolution_tpu_torch.parallel"):
        pipe = SRDiffPipeline(Hparams(TINY), params=sd, device="cpu")
        out = pipe.upscale_batch(lr_batch(9, (1, 8, 8, 3)))
    assert pipe.mesh.shape == {"dp": 1} and pipe.mesh.group is None
    assert out.shape == (1, 32, 32, 3) and not caplog.records
