"""Readings that a cell's check limits are set from: the program against
the plain reference on many seeds, and the control (the reference itself,
computed in float8 e4m3, in the program's place) on a few; or, with
``--fault``, the program with that fault planted (``harness/faults.py``).

    python3 benchmark/calibrate.py --workload <cell> [--seeds 12] [--control-seeds 3] [--first-seed N]
                                   [--fault NAME] [--out FILE]

One process builds the program once and, for each seed, draws that seed's
weights into it in place, serves the cell's sampled number of requests the
way the window does (its batch, its shapes, its requests in flight,
through the captured graphs), and compares them with the reference in
float32 (TF32 off); on the first ``--control-seeds`` seeds it also compares
the reference computed in float8 with one scale a tensor. It prints every
number of ``harness/check.py`` for each, judged against the cell's limits
as a run judges them (``correct``), the largest the program read and the
smallest the control read, and writes them as JSON to ``--out``.
Needs a CUDA card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--fault", default=None, help="a fault of harness/faults.py, planted in the program")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    from benchmark.harness import check, client, core, faults, spec
    from benchmark.reference import precision as P

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    device = torch.device("cuda")
    drv = spec.driver_module(cell.config["driver"]).Driver(cell.config, cell.traffic, device)
    t0 = time.perf_counter()
    drv.build(args.first_seed)
    print(f"{cell.name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    n_req = int(cell.workload["check"]["sample"])
    limits = cell.workload["check"]["limits"]

    def judged(numbers: dict) -> dict:
        verdicts = check.judge(numbers, limits)
        return {"numbers": numbers, "correct": all(j["ok"] for j in verdicts)}

    def planted():
        return faults.planted(cell.config["driver"], args.fault) if args.fault else contextlib.nullcontext()

    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        drv.load(seed)
        with planted():
            for j in range(int(cell.traffic["warmup"])):
                drv.fetch(drv.call(drv.request(seed, (1 << 41) + j)))
            win = client.run(drv, seed, int(cell.traffic["in_flight"]), count=n_req)
        errors = [r.error for r in win.attempted if r.error]
        P.no_tf32()
        model = drv.reference_model("meta")
        model.load_state_dict({n: v.float() for n, v in core._flat(drv.weights(seed)).items()}, strict=True,
                              assign=True)
        t1 = time.perf_counter()
        refs = [drv.reference(model, drv.request(seed, r.index)) for r in win.attempted]
        row = {"seed": seed, "fault": args.fault, "errors": errors,
               "reference_s": (time.perf_counter() - t1) / len(refs),
               "program": judged(check.image_numbers([r.output for r in win.attempted], refs))}
        if k < args.control_seeds:
            with P.computed_in("float8"):
                ctrl = [drv.reference(model, drv.request(seed, r.index)) for r in win.attempted]
            row["control"] = judged(check.image_numbers(ctrl, refs))
            with P.computed_in("bfloat16"):
                emu = [drv.reference(model, drv.request(seed, r.index)) for r in win.attempted]
            row["reference_bf16"] = check.image_numbers(emu, refs)
        del model, refs
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    ctrl_rows = [r["control"] for r in rows if "control" in r]
    summary = {"cell": cell.name, "card": core.card(device), "requests_a_seed": n_req, "fault": args.fault,
               "limits": limits, "rows": rows,
               "program_max": {n: max(r["program"]["numbers"][n] for r in rows) for n in check.NUMBERS},
               "program_correct": sum(r["program"]["correct"] for r in rows),
               "control_min": {n: min(c["numbers"][n] for c in ctrl_rows) for n in check.NUMBERS} if ctrl_rows
               else None,
               "control_correct": sum(c["correct"] for c in ctrl_rows), "control_runs": len(ctrl_rows)}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
