#!/usr/bin/env python3
"""The host-side numbers of the SRDiff training path, on the CPU (no card).

    python3 tools/torch_port_train_cpu.py [--hr 64] [--threads 8]

1. The DIV2K loader on this host: 64 PNGs written from a seed as
   ``chip_smoke.py``'s ``phase_train`` writes them, one sample's time
   (crop, flip, the PIL x1/4 and bicubic x4 numpy resizes) and a batch of 64
   through ``DataLoader`` with ``--threads`` threads.
2. The bf16 training gradients of the full-width stack (hidden 64, B = 2 at
   ``--hr``), with the regions (their plain versions here) against every
   region off and both against float32: the max and mean distances that
   ``phase_train``'s bf16 bounds are set from.

Prints one JSON line. CPU times say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def loader_times(threads: int) -> dict:
    from chip_smoke import TRAIN_BATCH, TRAIN_HR, write_train_pngs
    from dgm_img_super_resolution_tpu_torch.data import DataLoader, DIV2KDataset

    with tempfile.TemporaryDirectory() as d:
        write_train_pngs(d, seed=0)
        ds = DIV2KDataset(d, 4, TRAIN_HR, TRAIN_HR, data_augmentation=True)
        t0 = time.perf_counter()
        for i in range(16):
            ds[i]
        sample_ms = (time.perf_counter() - t0) / 16 * 1e3
        it = iter(DataLoader(ds, TRAIN_BATCH, num_workers=threads, endless=True))
        next(it)
        t0 = time.perf_counter()
        for _ in range(3):
            next(it)
        batch_s = (time.perf_counter() - t0) / 3
        it.close()
    return {"sample_ms": sample_ms, "batch_s": batch_s, "threads": threads}


def bf16_gaps(hr: int) -> dict:
    import torch

    from chip_smoke import CUDNN_ENV, TRAIN_T, _global_dist, _loss_and_grads, _train_batch, switches
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
    from dgm_img_super_resolution_tpu_torch.train.trainer import batch_to_device

    batch = batch_to_device(_train_batch(2, hr, 4), torch.device("cpu"))
    g = torch.Generator().manual_seed(5)
    noise = tuple(torch.randn(2, 3, hr, hr, generator=g) for _ in range(2))
    grads = {}
    for name, dtype, env in (("f32", "float32", CUDNN_ENV), ("regions", "bfloat16", {}), ("off", "bfloat16", CUDNN_ENV)):
        task = SRDiffTask(Hparams(compute_dtype=dtype, rrdb_ckpt=""))
        with switches(**env):
            grads[name] = _loss_and_grads(task, task.init_params(3), batch, torch.tensor(TRAIN_T), noise)[1]
    return {"regions_vs_off": _global_dist(grads["regions"], grads["off"]),
            "regions_vs_f32": _global_dist(grads["regions"], grads["f32"]),
            "off_vs_f32": _global_dist(grads["off"], grads["f32"]), "hr": hr}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hr", type=int, default=64, help="HR side of the gradient comparison")
    ap.add_argument("--threads", type=int, default=8, help="loader threads")
    args = ap.parse_args()
    print(json.dumps({"device": "cpu", "loader": loader_times(args.threads), "bf16_grads": bf16_gaps(args.hr)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
