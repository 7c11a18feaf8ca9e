#!/usr/bin/env python3
"""Time row 8 of the PyTorch port (``fused_group_norm``) under other plans than its own, at the SD sweep's shapes.

    python3 tools/torch_port_gn_plans.py [--out FILE]

At every (shape, groups, eps, act) of ``chip_smoke.gn_sweep`` and at
``chip_smoke.GN_SHAPES`` (NCHW, bf16), makes the plans that
``ops/kernels/group_norm.py:plan`` gives for each cluster size that the card
schedules (1, 2, 4, 8, 16) and times them by CUDA-graph replay (device time
alone) in turns through ``group_norm._launch``, the plan that the wrapper
chooses among them; prints how many clusters of each size run at once
(``group_norm.device_limits``). Each
plan's output is held against the plain version at ``chip_smoke``'s bf16
tolerance (another plan adds the sums in another order). Prints a line a
shape and one JSON line with every reading (also written to
``--out``). Builds only ``csrc/group_norm.cu``. Needs one CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    from chip_smoke import BF16_TOL, GN_SHAPES, _gn_inputs, card_line, gn_sweep, graph_ms, median
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build
    from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _build.SOURCES = ("group_norm",)  # the other kernels are not timed here
    sms, smem_cap, active = gn.device_limits(0)
    at_once = {1: sms, **dict(zip(gn.CLUSTERS, active))}
    out = {"card": card_line(), "sms": sms, "smem_cap": smem_cap, "active": at_once, "shapes": []}
    print(out["card"], f"{sms} SMs; clusters at once by size: {at_once}", flush=True)
    cases = [(shape, groups, eps, act) for shape, groups, eps, act, _ in gn_sweep()]
    cases += [(shape, 32, eps, "silu") for shape, eps in GN_SHAPES]
    failures = []
    for shape, groups, eps, act in cases:
        x, sc, bi = _gn_inputs(shape, torch.bfloat16, seed=shape[1] + shape[2])
        plans = {gn.plan_for(x, groups): "own"}
        for k in (k for k, a in at_once.items() if a > 0):
            plans.setdefault(gn.plan(*shape, groups, x.element_size(), False, sms, smem_cap, active, cluster=k),
                             f"x{k}")
        plain = gn.fused_group_norm_plain(x, sc, bi, groups, eps, act).float()
        calls = {name: (lambda p=p: gn._launch(x, sc, bi, groups, eps, act, p)) for p, name in plans.items()}
        for name, fn in calls.items():
            err = float((fn().float() - plain).abs().max() / plain.abs().max().clamp(min=1.0))
            if err > BF16_TOL:
                failures.append(f"{shape} {name}: error {err:.3g}")
        readings = {name: [] for name in calls}
        for _ in range(ROUNDS):
            for name, fn in calls.items():
                readings[name].append(graph_ms(fn))
        res = {"shape": shape, "groups": groups, "eps": eps, "act": act, "plans": [
            {"name": name, "route": p.route, "cluster": p.cluster, "slice_bytes": p.slice_units * p.unit_bytes,
             "buffers": p.buffers, "ms_graph": readings[name]} for p, name in plans.items()]}
        out["shapes"].append(res)
        best = min(calls, key=lambda name: median(readings[name]))
        print(f"{shape} G={groups} act={act}: " + "; ".join(
            f"{name} {p.route[:3]} x{p.cluster} {p.slice_units * p.unit_bytes // 1024} KB b{p.buffers} "
            f"{median(readings[name]):.4f}" for p, name in plans.items()) + f"; best {best}", flush=True)
        del x, plain
        torch.cuda.empty_cache()
    out["failures"] = failures
    text = json.dumps(out)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    for f in failures:
        print("FAIL", f, file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
