"""``parallel/mesh.py`` in one process, against the JAX package's
``parallel/mesh.py``: the mesh spec, ``init_distributed``'s gating, the
identities of a world of one, the ``dp`` and ``sp`` axes' coordinates and
sub-groups, and ``shard_batch``'s
rows and warning. The collectives over two ranks are in
``test_torch_port_dp_{serve,train}.py``.
"""

import datetime
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.parallel import mesh as jm
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.data.div2k import DIV2KDataset
from dgm_img_super_resolution_tpu_torch.parallel import mesh as pm
from dgm_img_super_resolution_tpu_torch.utils import draws
from dgm_img_super_resolution_tpu_torch.utils.misc import reduce_metrics

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("spec,n", [("", 8), ("dp=4,sp=2", 8), ("dp=8", 8), ("", 1), ("dp=2,sp=1", 2)])
def test_parse_mesh_shape_matches_jax(spec, n):
    assert pm.parse_mesh_shape(spec, n) == jm.parse_mesh_shape(spec, n)


@pytest.mark.parametrize("spec,n", [("dp=3", 8), ("dp=2,sp=2", 2)])
def test_parse_mesh_shape_errors_as_jax(spec, n):
    for parse in (pm.parse_mesh_shape, jm.parse_mesh_shape):
        with pytest.raises(ValueError, match="needs"):
            parse(spec, n)


def test_init_distributed_gating(monkeypatch):
    """Without torchrun's environment: a no-op returning False. With it:
    ``init_process_group`` once, over env://, gloo without CUDA or the
    backend asked for, with a timeout; a second call does nothing more."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    calls, joined = [], [False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: joined[0])

    def init(**kw):
        calls.append(kw)
        joined[0] = True

    monkeypatch.setattr(pm.dist, "init_process_group", init)
    monkeypatch.setattr(pm.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(pm.dist, "get_world_size", lambda: 2)
    assert pm.init_distributed() is False and calls == []
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert pm.init_distributed() is False and calls == []  # MASTER_ADDR and _PORT missing
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    assert pm.init_distributed(timeout_s=30) is True
    assert calls == [{"backend": "gloo", "init_method": "env://", "timeout": datetime.timedelta(seconds=30)}]
    assert pm.init_distributed() is True and len(calls) == 1
    joined[0] = False
    assert pm.init_distributed(backend="mpi") is True
    assert calls[-1]["backend"] == "mpi"
    assert calls[-1]["timeout"] == datetime.timedelta(seconds=pm.DEFAULT_TIMEOUT_S)


def test_world_of_one_is_the_identity():
    mesh = pm.make_mesh()
    assert (mesh.shape, mesh.rank, mesh.world, mesh.group) == ({"dp": 1}, 0, 1, None)
    x = torch.arange(12.0).reshape(4, 3)
    rows = pm.batch_rows(4, mesh)
    assert rows == pm.Rows(0, 4, 4) and not rows.split
    tree = {"a": x, "b": [np.ones((2, 1))], "s": 3}
    out = pm.shard_batch(tree, mesh)
    assert out["a"] is x and out["b"][0] is tree["b"][0] and out["s"] == 3
    assert pm.gather_rows(x, rows, mesh) is x
    ts = [x.clone()]
    assert pm.all_reduce_mean(ts, mesh) is ts and torch.equal(ts[0], x)
    lin = torch.nn.Linear(2, 2)
    w = lin.weight.detach().clone()
    assert pm.replicate(lin, mesh) is lin and torch.equal(lin.weight, w)
    metrics = {"loss": torch.tensor(2.0), "n": 3}
    assert reduce_metrics(metrics) is metrics
    pm.barrier(mesh)
    assert pm.is_main(mesh)
    assert pm.broadcast_object({"k": 1}, mesh) == {"k": 1}


@pytest.mark.parametrize("spec", ["dp=2,sp=2", "sp=4", "dp=1,tp=4"])
def test_axes_other_than_dp_raise(monkeypatch, spec):
    """An axis other than dp and sp raises, naming the ROADMAP, and is never
    folded into dp; ``sp=1`` is a dp mesh. A mesh with sp builds on every
    rank: its shape, the rank's (dp, sp) coordinates (the ranks reshaped
    row-major, as JAX's devices), the sub-groups along each axis that hold
    the rank, made in one order on every rank, and ``batch_rows`` by the dp
    coordinate (replicated over sp)."""
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pm.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(pm.dist, "get_rank", lambda: 0)
    made = []
    monkeypatch.setattr(pm.dist, "new_group", lambda ranks: made.append(tuple(ranks)) or tuple(ranks))
    if "tp" in spec:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pm.make_mesh(spec)
    else:
        shape = pm.parse_mesh_shape(spec, 4)
        for r in range(4):
            made.clear()
            monkeypatch.setattr(pm.dist, "get_rank", lambda r=r: r)
            mesh = pm.make_mesh(spec)
            dp, sp = (r // 2, r % 2) if spec == "dp=2,sp=2" else (0, r)
            assert mesh.shape == shape and mesh.rank == r and (mesh.dp_rank, mesh.sp_rank) == (dp, sp)
            assert pm.batch_rows(4, mesh) == (pm.Rows(2 * dp, 2 * dp + 2, 4) if mesh.dp == 2 else pm.Rows(0, 4, 4))
            assert pm.even_rows(16, mesh.sp_rank, mesh.sp) == pm.Rows(sp * 16 // mesh.sp, (sp + 1) * 16 // mesh.sp, 16)
            assert pm.shard_spatial(16, mesh) == pm.Rows(4 * r, 4 * r + 4, 16)
            if spec == "dp=2,sp=2":
                assert made == [(0, 2), (1, 3), (0, 1), (2, 3)]
                assert mesh.dp_group == (sp, sp + 2) and mesh.sp_group == (2 * dp, 2 * dp + 1)
            else:  # sp spans the world: its group is the world's, and dp has none
                assert made == [] and mesh.sp_group is mesh.group and mesh.dp_group is None
    assert pm.make_mesh("dp=4,sp=1").shape == {"dp": 4, "sp": 1}


@pytest.mark.parametrize("n", [8, 16])
def test_shard_batch_rows_are_jaxs_shards(n):
    """Rank r of a dp=4 mesh holds the rows that JAX's ``shard_batch``
    places on device r of a dp=4 mesh."""
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    xs = jm.shard_batch(jnp.asarray(x), jm.make_mesh("dp=4", devices=jax.devices()[:4]))
    by_device = {s.device.id: np.asarray(s.data) for s in xs.addressable_shards}
    for r in range(4):
        mesh = pm.Mesh({"dp": 4}, r)
        got = pm.shard_batch({"x": x}, mesh)["x"]
        np.testing.assert_array_equal(got, by_device[jax.devices()[r].id])
        rows = pm.batch_rows(n, mesh)
        assert rows.split and (rows.start, rows.stop) == (r * n // 4, (r + 1) * n // 4)


@pytest.mark.parametrize("channels_last", [False, True])
def test_row_draws_are_the_global_draws_rows(channels_last):
    """A ``RowDraws`` over a generator draws the global batch's numbers and
    keeps its rows; a plain generator draws as torch's own calls."""
    n, shape = 8, (8, 3, 4, 5)
    x = torch.zeros(shape)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    whole = (draws.randint(10, (n,), g(), "cpu"), draws.randn(shape, g(), "cpu"), draws.normal_like(x, g()))
    assert torch.equal(whole[0], torch.randint(0, 10, (n,), generator=g()))
    assert torch.equal(whole[1], torch.randn(shape, generator=g()))
    assert torch.equal(whole[2], torch.empty_like(x).normal_(generator=g()))
    for r in range(4):
        rows = pm.batch_rows(n, pm.Mesh({"dp": 4}, r))
        part = (draws.randint(10, (2,), draws.RowDraws(g(), rows), "cpu"),
                draws.randn((2,) + shape[1:], draws.RowDraws(g(), rows), "cpu"),
                draws.normal_like(rows.take(x), draws.RowDraws(g(), rows)))
        for a, b in zip(part, whole):
            assert torch.equal(a, rows.take(b))
        assert part[2].is_contiguous(memory_format=torch.channels_last) == channels_last


def test_shard_batch_warns_on_non_divisible(caplog):
    """As JAX's ``test_shard_batch_warns_on_non_divisible``: 3 rows on dp=8
    are replicated, with the warning, on every rank."""
    for r in (0, 5):
        with caplog.at_level(logging.WARNING, logger="dgm_img_super_resolution_tpu_torch.parallel"):
            xs = pm.shard_batch(torch.zeros(3, 4, 4, 3), pm.Mesh({"dp": 8}, r))
        assert any("replicating" in rec.message for rec in caplog.records)
        assert xs.shape == (3, 4, 4, 3)
        caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dgm_img_super_resolution_tpu_torch.parallel"):
        assert pm.shard_batch(torch.zeros(16, 2), pm.Mesh({"dp": 8}, 1)).shape == (2, 2)
    assert not caplog.records


def test_resolve_device_without_cuda_raises_under_a_group(monkeypatch):
    """``None`` is the rank's card under a process group; without CUDA it
    raises rather than carry on on the CPU, as without a group."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_local_cuda_device_is_the_local_rank(monkeypatch):
    """cuda:LOCAL_RANK; more local ranks than cards only under gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(pm.dist, "get_backend", lambda *a: "nccl")
    assert pm.local_cuda_device() == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.local_cuda_device()
    monkeypatch.setattr(pm.dist, "get_backend", lambda *a: "gloo")
    assert pm.local_cuda_device() == torch.device("cuda", 1)


def test_div2k_crops_by_rank(tmp_path):
    """Rank 0 draws the one-process stream; rank 1 another."""
    from PIL import Image

    Image.fromarray(np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(tmp_path / "a.png")
    kw = dict(scale_factor=4, hr_height=16, hr_width=16, data_augmentation=True, seed=3)
    one, r0, r1 = (DIV2KDataset(str(tmp_path), **kw, **extra)[0]["hr"] for extra in ({}, {"rank": 0}, {"rank": 1}))
    np.testing.assert_array_equal(one, r0)
    assert np.abs(one - r1).max() > 0
