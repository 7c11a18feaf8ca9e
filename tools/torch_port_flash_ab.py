#!/usr/bin/env python3
"""Time one checkout's flash-attention kernel beside SDPA (the PyTorch port).

    python3 tools/torch_port_flash_ab.py [--root DIR]

Imports ``dgm_img_super_resolution_tpu_torch`` from the checkout at ``--root``
(default: this one), which builds its kernels into that checkout's
``build/kernels``, and times its ``flash_attention`` in bf16 at the SD x4
path's shape (2, 1024, 8, 128) and at a ragged L = 1089 (LR 264), in turns
with ``F.scaled_dot_product_attention`` by ``chip_smoke.time_in_turns``:
launched one by one (``chip_smoke.cuda_ms``, as the kernel table's ``ms``)
and replayed from a CUDA graph (``chip_smoke.graph_ms``, device time alone).
Run it on two checkouts in turns (A B B A) to compare their kernels on one
card. Prints the medians and ranges, and one JSON line with every reading.
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((2, 1024, 8, 128), (1, 1089, 8, 128))  # (B, L, H, D)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="checkout whose kernel is timed (and built)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(HERE))
    from chip_smoke import card_line, cuda_ms, graph_ms, median, time_in_turns

    sys.path.insert(0, str(args.root.resolve()))
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = {"card": card_line(), "root": str(args.root), "shapes": {}}
    for b, l, h, d in SHAPES:
        g = torch.Generator().manual_seed(l)
        q, k, v = (torch.randn(b, l, h, d, generator=g).to("cuda", torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, L, D), as views
        kern = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
        res = {}
        for how, timer in (("eager", cuda_ms), ("graph", graph_ms)):
            ks, ss = time_in_turns(kern, sdpa, timer)
            res[how] = {"kernel_ms": ks, "sdpa_ms": ss}
            flops = 4.0 * b * h * l * l * d
            print(f"{args.root} {(b, l, h, d)} {how}: kernel median {median(ks):.4f} ms ({min(ks):.4f}-"
                  f"{max(ks):.4f}, {flops / median(ks) / 1e9:.0f} TFLOP/s), SDPA median {median(ss):.4f} ms "
                  f"({min(ss):.4f}-{max(ss):.4f})", flush=True)
        out["shapes"][str((b, l, h, d))] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
