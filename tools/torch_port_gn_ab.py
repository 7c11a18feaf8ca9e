#!/usr/bin/env python3
"""Time one checkout's GroupNorm kernel (row 8, the PyTorch port) at the SD sweep's shapes.

    python3 tools/torch_port_gn_ab.py [--root DIR] [--out FILE]

Imports ``dgm_img_super_resolution_tpu_torch`` from the checkout at ``--root``
(default: this one), builds only its ``csrc/group_norm.cu`` into that
checkout's ``build/kernels``, and times its ``fused_group_norm`` in bf16 at
every (shape, groups, eps, act) of ``chip_smoke.gn_sweep`` (NCHW, the SD
serves' GroupNorm calls at LR 256 and 128) and at ``chip_smoke.GN_SHAPES``
with SiLU in both layouts, in turns with the PyTorch call of the same
function (``F.group_norm``, with ``F.silu`` where the model applies it) by
``chip_smoke.time_in_turns``: launched one by one under CUDA events (as the
kernel table's ``ms``; at small shapes the host's launch path) and replayed
from a CUDA graph (device time alone). The shapes and timers are
this checkout's, so two checkouts run in turns (A B B A) compare their
kernels on one card. Prints the medians
and one JSON line with every reading (also written to ``--out``). Needs one
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="checkout whose kernel is timed (and built)")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(HERE))
    from chip_smoke import GN_SHAPES, _gn_inputs, card_line, cuda_ms, gn_sweep, graph_ms, median, time_in_turns

    sys.path.insert(0, str(args.root.resolve()))
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build
    from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _build.SOURCES = ("group_norm",)  # the other kernels are not timed here
    out = {"card": card_line(), "root": str(args.root), "shapes": []}
    cases = [(shape, groups, eps, act, False) for shape, groups, eps, act, _ in gn_sweep()]
    cases += [(shape, 32, eps, "silu", cl) for shape, eps in GN_SHAPES for cl in (False, True)]
    for shape, groups, eps, act, cl in cases:
        x, sc, bi = _gn_inputs(shape, torch.bfloat16, seed=shape[1] + shape[2], channels_last=cl)
        scb, bib = sc.to(x.dtype), bi.to(x.dtype)
        if act == "silu":
            lib = lambda: F.silu(F.group_norm(x, groups, scb, bib, eps))  # noqa: E731
        else:
            lib = lambda: F.group_norm(x, groups, scb, bib, eps)  # noqa: E731
        kern = lambda: gn.fused_group_norm(x, sc, bi, groups, eps, act)  # noqa: E731
        ks, ls = time_in_turns(kern, lib, cuda_ms)
        gs, gls = time_in_turns(kern, lib, graph_ms)
        res = {"shape": shape, "groups": groups, "eps": eps, "act": act, "channels_last": cl,
               "kernel_ms": ks, "library_ms": ls, "kernel_ms_graph": gs, "library_ms_graph": gls}
        line = f"{args.root} {shape} {'NHWC' if cl else 'NCHW'} act={act}: kernel {median(ks):.4f} ms, " \
               f"library {median(ls):.4f} ms; by graph replay kernel {median(gs):.4f} ms, library " \
               f"{median(gls):.4f} ms"
        print(line, flush=True)
        out["shapes"].append(res)
        del x
        torch.cuda.empty_cache()
    text = json.dumps(out)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
