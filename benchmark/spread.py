"""Run one cell several times, each run its own process as a check runs
it, and print each end-to-end metric's spread.

    python3 benchmark/spread.py --workload <cell> --seeds S1,S2,... [--sets 2] [--seconds N] [--trace 0]
                                [--out FILE]

Each set runs ``run.py`` once per seed, in order; every set takes the same
seeds. A spread is the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median. Prints
each run's result line, then per metric each set's median and spread, and
writes everything as JSON lines to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    median = statistics.median(values)
    if median == 0:
        return 0.0 if q3 == q1 else float("inf")
    return (q3 - q1) / median


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None, help="BENCHMARK.json's run_seconds by default")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = []
    for k in range(args.sets):
        for seed in seeds:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", args.workload,
                                "--seed", str(seed), "--seconds", str(seconds), "--trace", str(args.trace)],
                               cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            out = p.stdout.strip().splitlines()
            try:
                res = json.loads(out[-1]) if p.returncode == 0 and out else None
            except json.JSONDecodeError:
                res = None
            line = {"set": k, "seed": seed, "rc": p.returncode, "wall_s": wall, "result": res,
                    "stderr_tail": p.stderr[-1500:] if res is None or not res.get("correct") else p.stderr[-400:]}
            lines.append(line)
            print(json.dumps(line), flush=True)
    for k in range(args.sets):
        runs = [ln["result"] for ln in lines if ln["set"] == k and ln["result"]]
        names = sorted({m for r in runs for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in runs if m in r["metrics"]]
            if len(vals) >= 2:
                print(f"set {k} {m}: median {statistics.median(vals)!r} spread {spread(vals):.5f} "
                      f"values {vals}", flush=True)
        print(f"set {k}: correct {sum(r['correct'] for r in runs)} of {len(runs)} runs "
              f"(of {sum(ln['set'] == k for ln in lines)})", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
