"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell, and the
cell's configuration, traffic and check sit in files of their own under
``benchmark/`` (``harness/spec.py``). It builds the program
(``dgm_img_super_resolution_tpu_torch``) with weights made on the card from
the seed, warms up the cell's shape (set-up, ``setup_s``), measures for
``--seconds`` seconds, and checks what the window produced against the
plain reference under ``benchmark/reference/``. ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` profiles a few more requests and
reports its per-layer metrics, ``device.busy_s`` and ``device.window_s``,
and ``breakdown``.

The last line of standard output is the result, one JSON object; the last
lines of standard error are each number compared beside its limit. With no
CUDA card, fewer cards than the cell asks for, or JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
Build and kernel caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "triton", "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "DGMSR_KERNEL_BUILD_DIR": ROOT / "build" / "kernels"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)

    import torch

    from benchmark.harness import core, spec

    cell = spec.resolve(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {cell.name} needs {chips} CUDA card(s), this process sees {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = core.banned_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line, notes = emit(result)
    for note in notes:
        print(note, file=sys.stderr)
    print(line, flush=True)
    return 0


def emit(result: dict) -> tuple[str, list[str]]:
    """The result's line (its keys in the contract's order, ``check``
    last) and the notes for standard error, the numbers compared beside
    their limits last."""
    chk = result["_check"]
    notes = [f"benchmark: request failed: {e}" for e in result["_errors"]]
    notes.append(f"benchmark: sampled requests {chk['sampled']}; all numbers {json.dumps(chk['numbers'])}")
    notes += [f"check {j['name']} {j['value']!r} limit {j['limit']!r} {'ok' if j['ok'] else 'FAILED'}"
              for j in chk["judged"]]
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "check")
    return json.dumps({k: result[k] for k in keys if k in result}), notes


if __name__ == "__main__":
    sys.exit(main())
