#!/usr/bin/env python3
"""A/B of the SRDiff kernel configurations on one GPU (the PyTorch port).

    python3 tools/torch_port_ab.py [--rounds 4] [--batches 3] [--steps 20] [--configs default,A,B,C]
                                   [--enc-intervals 1]

Serves the default full-width SRDiff config (seeded random weights, bf16,
DDIM ``--steps`` steps with eta 1, batch 8 of 128x128 uint8 LR -> 512x512)
under each configuration of the kernel switches of ``chip_smoke.CONFIGS``
(the defaults; A, the Downsample fold and the head-fused chain; B, the
per-conv conv3x3 in place of the three regions; C, every ResnetBlock pair
through the chain kernel; ``--configs`` picks some), at each encoder
propagation interval of ``--enc-intervals`` (an arm is a configuration at
one K), in turns: every round runs the arms in order and then in reverse
(default, A, B, C, C, B, A, default), ``--batches`` timed batches each,
after one warm-up batch per arm. The same noise (a generator seeded 0) for every batch.
Prints each configuration's median img/s with its spread, and one JSON line
with every batch time. Needs one CUDA device and nvcc; run from the root of
the repository.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--configs", default="default,A,B,C", help="comma-separated names of chip_smoke.CONFIGS")
    ap.add_argument("--enc-intervals", default="1", help="comma-separated encoder propagation intervals")
    args = ap.parse_args()

    import numpy as np
    import torch

    from chip_smoke import CONFIGS, card_line, switches
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    hp = Hparams(sampler="ddim", sample_timesteps=args.steps, ddim_eta=1.0, compute_dtype="bfloat16")
    pipe = SRDiffPipeline(hp)
    imgs = np.random.default_rng(0).integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)

    def serve() -> float:
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.upscale_batch_device(imgs, generator=gen, as_uint8=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ks = [int(k) for k in args.enc_intervals.split(",")]
    arms = {(f"{c}_k{k}" if ks != [1] else c): (c, k) for k in ks for c in args.configs.split(",")}

    def run(name):
        cfg, k = arms[name]
        pipe.hp = hp.replace(enc_interval=k)
        with switches(**CONFIGS[cfg]):
            return serve()

    for name in arms:
        run(name)  # warm-up: first-call set-up of this arm's convs
    times = {name: [] for name in arms}
    order = list(arms)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            times[name] += [run(name) for _ in range(args.batches)]
    power = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; after the runs: {power}")
    res = {}
    for name, ts in times.items():
        rates = sorted(8 / t for t in ts)
        res[name] = {"img_per_s_median": statistics.median(rates), "img_per_s_min": rates[0],
                     "img_per_s_max": rates[-1], "batch_s": ts}
        print(f"{name:10s} {CONFIGS[arms[name][0]]} enc_interval {arms[name][1]}: {statistics.median(rates):.3f} "
              f"img/s median of {len(ts)} "
              f"batches (min {rates[0]:.3f}, max {rates[-1]:.3f})")
    print(json.dumps({"card": card, "steps": args.steps, "configs": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
