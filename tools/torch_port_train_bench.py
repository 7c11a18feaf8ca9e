"""Training throughput of the PyTorch port: the SRDiff training step at the
config's shape on one CUDA card (counterpart of ``tools/train_bench.py``,
which measures the JAX package's).

The upstream recipe (``srdiff/config.yaml``: batch 64 of 160x160 HR crops,
lr 2e-4, bf16 compute) through the port's entry points:
``SRDiffTask(hp).make_trainer(device=..., mesh=make_mesh(spec))``,
``init_state(0)``, a uniform batch of ``hr``, ``lr`` and ``lr_up`` in
[-1, 1] from ``np.random.default_rng(0)`` put on the device once, and
``trainer.compile_step()``. The first step (seed 1: the eager step and the
capture of its CUDA graphs) is ``compile_s``; then ``BENCH_ITERS`` (20)
steps with generators seeded ``2 + i``, synchronised once at the end.

Knobs, as ``train_bench.py``'s: ``--tiny`` (hidden 16, RRDB 3 x 16, T = 8,
float32, batch 8 of 32x32), ``BENCH_BATCH`` (64), ``BENCH_PATCH`` (160),
``BENCH_ITERS``, ``TRAIN_BENCH_MESH`` (``hp['mesh_shape']`` over the
process group; a captured step runs one process) and ``TRAIN_BENCH_OUT``
(also write the JSON there). Prints ONE JSON line with ``train_bench.py``'s
keys; ``mesh`` and ``n_devices`` count the process group's ranks (1
without one), ``backend`` is ``cuda`` or ``cpu``, and ``device`` the
card's name and power limit (``nvidia-smi``) or ``cpu``.

Usage, from anywhere in a checkout: ``python tools/torch_port_train_bench.py
[--tiny] [--device D]``; the CUDA device by default, and with none and no
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgm_img_super_resolution_tpu_torch.core.config import Hparams  # noqa: E402
from dgm_img_super_resolution_tpu_torch.core.device import card_description, resolve_device  # noqa: E402
from dgm_img_super_resolution_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask  # noqa: E402
from dgm_img_super_resolution_tpu_torch.utils.misc import to_device  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="a tiny model at 32x32: a sanity run")
    ap.add_argument("--device", default="", help="torch device; the CUDA device by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or None)
    if args.tiny:
        hp = Hparams(compute_dtype="float32", hidden_size=16, rrdb_num_block=3, rrdb_num_feat=16, timesteps=8,
                     val_check_interval=0)
        batch_n, hr = int(os.environ.get("BENCH_BATCH", "8")), 32
    else:
        # the config the keys describe: full models, batch 64, 160^2 HR crops, bf16 compute
        hp = Hparams(compute_dtype="bfloat16", val_check_interval=0)
        batch_n = int(os.environ.get("BENCH_BATCH", "64"))
        hr = int(os.environ.get("BENCH_PATCH", "160"))

    mesh_spec = os.environ.get("TRAIN_BENCH_MESH", "")
    mesh = make_mesh(mesh_spec)
    task = SRDiffTask(hp)
    trainer = task.make_trainer(device=device, mesh=mesh)
    state = trainer.init_state(0)

    scale = hp["sr_scale"]
    g = np.random.default_rng(0)
    batch = {
        "hr": g.uniform(-1, 1, (batch_n, hr, hr, 3)).astype(np.float32),
        "lr": g.uniform(-1, 1, (batch_n, hr // scale, hr // scale, 3)).astype(np.float32),
        "lr_up": g.uniform(-1, 1, (batch_n, hr, hr, 3)).astype(np.float32),
    }
    # on the device once, NHWC as the loader gives it: the step's
    # batch_to_device then only views it as NCHW
    batch = to_device(batch, device)
    step_fn = trainer.compile_step()

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    # the first step: eager, then captured
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch, gen(1))
    loss0 = float(metrics["loss"])  # syncs
    compile_s = time.perf_counter() - t0

    iters = int(os.environ.get("BENCH_ITERS", "20"))
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = step_fn(state, batch, gen(2 + i))
    loss = float(metrics["loss"])  # sync once at the end
    dt = time.perf_counter() - t0

    result = {
        "metric": "srdiff_train_steps_per_sec",
        "value": round(iters / dt, 4),
        "images_per_sec": round(batch_n * iters / dt, 2),
        "step_ms": round(1000 * dt / iters, 2),
        "batch": batch_n,
        "hr_crop": hr,
        "compute_dtype": hp["compute_dtype"],
        "mesh": mesh_spec or f"dp={mesh.world}",
        "n_devices": int(mesh.world),
        "tiny": args.tiny,
        "compile_s": round(compile_s, 1),
        "loss_first": round(loss0, 4),
        "loss_last": round(loss, 4),
        "backend": device.type,
        "device": card_description(device),
    }
    print(json.dumps(result), flush=True)
    if os.environ.get("TRAIN_BENCH_OUT"):
        with open(os.environ["TRAIN_BENCH_OUT"], "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
