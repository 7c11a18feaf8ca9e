"""The rank side of the port's data-parallel tests: one process of a gloo
group on the CPU, as ``torchrun`` starts it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    python tests/torch_port_dp_ranks.py serve|train DIR

reads ``DIR/inputs.pt`` (written by the test, which computed the JAX
references), runs the port's entry points under ``init_distributed()`` and
writes what it saw to ``DIR/rank<R>.pt``. It imports no JAX: the tests hold
what it writes against JAX in the test's own process. ``spawn_ranks`` starts
the ranks and waits for them.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def spawn_ranks(mode: str, work: Path, world: int = 2, timeout: float = 240.0) -> list[dict]:
    """Run ``world`` ranks of ``mode`` over ``work``; their outputs, by rank.
    A rank that fails, or a group that outlasts ``timeout``, fails the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
        procs.append(subprocess.Popen([sys.executable, __file__, mode, str(work)], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(work / f"rank{r}.pt", weights_only=False) | {"log": logs[r]} for r in range(world)]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# ------------------------------------------------------------------- serve
def run_serve(inp: dict, mesh) -> dict:
    """Each case through ``upscale_batch`` (or ``upscale_large``), with the
    batch sizes of the pipeline's ``upscale_batch_device`` calls, the
    warnings of the mesh's logger and the progress calls."""
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import ChunkNoise, SRDiffPipeline

    records = _Records()
    logging.getLogger("dgm_img_super_resolution_tpu_torch.parallel").addHandler(records)
    out = {}
    for name, case in inp["cases"].items():
        pipe = SRDiffPipeline(Hparams(case["hp"]), params=inp["state_dict"], device="cpu")
        calls, seen = [], []
        orig = pipe.upscale_batch_device

        def spy(imgs, *a, _orig=orig, **k):
            calls.append(int(imgs.shape[0]))
            return _orig(imgs, *a, **k)

        pipe.upscale_batch_device = spy
        noises, shapes = case["noise"], []
        noise = None if noises is None else ChunkNoise(
            lambda path, shape, _n=noises: (shapes.append((path, shape)), _n[path])[1])
        gen = torch.Generator().manual_seed(case.get("seed", 0))
        records.messages.clear()
        if case.get("large"):
            img = pipe.upscale_large(case["lr"], patch=case["large"]["patch"], overlap=case["large"]["overlap"],
                                     generator=gen, noise=noise)
        else:
            cb = (lambda d, t: seen.append((d, t))) if case.get("progress") else None
            img = pipe.upscale_batch(case["lr"], generator=gen, noise=noise, progress_cb=cb)
        out[name] = {"img": img, "calls": calls, "warnings": list(records.messages), "progress": seen,
                     "noise_shapes": shapes,
                     "mesh": pipe.mesh.shape, "device": str(pipe.device)}
    return out


# ------------------------------------------------------------------- train
def _snapshot(state) -> dict:
    model, adam = state.model, state.optimizer.adam
    named = list(model.named_parameters())
    return {"params": {n: p.detach().clone() for n, p in named},
            "mu": {n: adam.state[p]["exp_avg"].clone() for n, p in named if p in adam.state},
            "nu": {n: adam.state[p]["exp_avg_sq"].clone() for n, p in named if p in adam.state},
            "ema": None if state.ema is None else {n: v.clone() for n, v in state.ema.items()},
            "step": state.step, "updates": state.optimizer.updates}


def run_train(inp: dict, mesh) -> dict:
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.data.loader import DataLoader
    from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff
    from dgm_img_super_resolution_tpu_torch.models.param_transforms import apply_weight_norm
    from dgm_img_super_resolution_tpu_torch.parallel import mesh as pm
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
    from dgm_img_super_resolution_tpu_torch.train.tasks.vae import DDPMTask
    from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer
    from dgm_img_super_resolution_tpu_torch.utils.misc import reduce_metrics

    out: dict = {"rank": mesh.rank, "mesh": mesh.shape}
    work = Path(inp["work"])

    # the SRDiff trainer: the global batches and JAX's draws over them
    hp = Hparams(inp["hp"])

    def trainer(sd):
        model = build_srdiff(hp)
        if hp["use_wn"]:
            apply_weight_norm(model.denoise_fn)
        model.load_state_dict(sd)
        return Trainer(hp, SRDiffTask(hp, model).loss_fn, init_params_fn=lambda seed: model, device="cpu",
                       work_dir=str(work / "srdiff"))

    # rank 1 starts from zeros: init_state broadcasts rank 0's
    zeros = {k: torch.zeros_like(v) for k, v in inp["state_dict"].items()}
    tr = trainer(inp["state_dict"] if mesh.rank == 0 else zeros)
    state = tr.init_state()
    steps = []
    for batch, (t, noise) in zip(inp["batches"], inp["draws"]):
        state, m = tr.train_step(state, batch, t=t, noise=noise)
        steps.append({"metrics": {k: float(v) for k, v in m.items()}, **_snapshot(state)})
    out["steps"] = steps

    # rank 0 writes the one checkpoint; both ranks resume from it into a zeroed state, rank 1
    # from a work dir of its own that holds none (a disk local to its host): rank 0's is broadcast
    tr.save(state, state.step)
    out["ckpts"] = sorted(os.listdir(tr.work_dir))
    tr2 = trainer(zeros)
    if mesh.rank:
        tr2.work_dir = str(work / "rank1_local")
    ckpt, step = tr2.load_latest()
    fresh = tr2.init_state()
    tr2.restore(fresh, ckpt)
    out["resumed"] = {"step": step, **_snapshot(fresh)}

    # fit: rank 0 logs and saves, every rank resumes
    fit_dir = work / "fit"
    fit_tr = SRDiffTask(hp, build_srdiff(hp)).make_trainer(device="cpu")
    fit_tr.work_dir = str(fit_dir)
    batches = [dict(b) for b in inp["batches"]]
    fit_tr.fit(iter(batches), 0, max_updates=2, log_every=1)
    out["fit_files"] = sorted(os.listdir(fit_dir))
    pm.barrier()
    out["fit_log_lines"] = len((fit_dir / "metrics.jsonl").read_text().splitlines())
    fit_tr2 = SRDiffTask(hp, build_srdiff(hp)).make_trainer(device="cpu")
    fit_tr2.work_dir = str(fit_dir)
    fit_tr2.fit(iter(batches), 0, max_updates=3, log_every=1)
    out["fit_files_after_resume"] = sorted(os.listdir(fit_dir))

    # one DDPM step from a seeded generator
    dtask = DDPMTask(Hparams(inp["ddpm_hp"]), img_hw=8, device="cpu")
    dtr = dtask.make_trainer()
    dstate = dtr.init_state(0)
    dstate, dm = dtr.train_step(dstate, {"x": inp["ddpm_x"]}, torch.Generator().manual_seed(5))
    out["ddpm"] = {"metrics": {k: float(v) for k, v in dm.items()}, **_snapshot(dstate)}

    # the loader's rows of each global batch
    class Items:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return {"i": np.array([i]), "x": np.full((2, 2, 1), float(i), np.float32)}

    loader = DataLoader(Items(), batch_size=4, seed=3, num_workers=4, mesh=mesh)
    out["loader"] = {"num_workers": loader.num_workers,
                     "shards": [(s.rows, s.data["i"][:, 0].tolist()) for s in loader]}

    # the collectives on their own
    x = torch.arange(8.0).reshape(4, 2) + 100 * mesh.rank
    rows = pm.batch_rows(4, mesh)
    out["gather"] = pm.gather_rows(rows.take(torch.arange(12.0).reshape(4, 3)), rows, mesh)
    out["mean"] = pm.all_reduce_mean([x.clone()], mesh)[0]
    out["replicated"] = pm.replicate({"a": x.clone(), "m": torch.nn.Linear(2, 2)}, mesh)["a"]
    out["reduced"] = reduce_metrics({"loss": torch.tensor(1.0 + mesh.rank), "n": 2 * mesh.rank,
                                     "v": torch.tensor([1.0, 3.0]) * (mesh.rank + 1), "name": "x"}, mesh=mesh)
    try:
        pm.make_mesh("dp=1,sp=2")
        out["sp_error"] = None
    except NotImplementedError as e:
        out["sp_error"] = str(e)
    return out


def main(mode: str, work: str) -> None:
    torch.set_num_threads(1)
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import init_distributed, make_mesh

    assert init_distributed() and init_distributed()  # joins once; the second call is a no-op
    import torch.distributed as dist

    mesh = make_mesh()
    work_dir = Path(work)
    inp = torch.load(work_dir / "inputs.pt", weights_only=False)
    out = {"serve": run_serve, "train": run_train}[mode](inp, mesh)
    out["backend"] = dist.get_backend()
    torch.save(out, work_dir / f"rank{mesh.rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
