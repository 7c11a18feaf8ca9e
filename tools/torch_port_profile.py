#!/usr/bin/env python3
"""Where the time of one SRDiff x4 serve goes on the GPU (the PyTorch port).

    python3 tools/torch_port_profile.py [--batch 8] [--steps 20] [--out DIR]

Serves the default full-width config (seeded random weights, bf16, DDIM
``--steps`` steps with eta 1, 128x128 uint8 LR -> 512x512) once to warm up,
then once under ``torch.profiler``. Prints the device time by kernel class
and the top kernels, the device's busy and idle share of the wall time, and
one JSON line with the same numbers. ``--out DIR`` also writes a Chrome trace.
Needs one CUDA device and nvcc; run from the root of the repository.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def kernel_class(name: str) -> str:
    if "conv_tile_kernel" in name or "stem_kernel" in name:
        return "port kernels (3 regions)"
    low = name.lower()
    if any(k in low for k in ("xmma", "implicit_gemm", "cudnn", "cutlass", "conv", "gemm", "sm90")):
        return "cuDNN / cuBLAS convs and matmuls"
    return "elementwise, copies and other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    hp = Hparams(sampler="ddim", sample_timesteps=args.steps, ddim_eta=1.0, compute_dtype="bfloat16")
    pipe = SRDiffPipeline(hp)
    imgs = np.random.default_rng(0).integers(0, 256, (args.batch, 128, 128, 3), dtype=np.uint8)
    pipe.upscale_batch_device(imgs, as_uint8=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.upscale_batch_device(imgs, as_uint8=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.device_time_total for a in kernels) / 1e3
    by_class: dict[str, float] = {}
    for a in kernels:
        c = kernel_class(a.key)
        by_class[c] = by_class.get(c, 0.0) + a.device_time_total / 1e3
    card = torch.cuda.get_device_name(0)
    print(f"{card}: batch {args.batch}, ddim{args.steps}: wall {wall_ms:.1f} ms (profiled), "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel names")
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:36s} {ms:9.1f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f}% of device time")
    top = sorted(kernels, key=lambda a: -a.device_time_total)[:20]
    for a in top:
        print(f"  {a.device_time_total / 1e3:9.2f} ms  x{a.count:<5d} {a.key[:110]}")
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "torch_port_profile.json"))
    print(json.dumps({"card": card, "batch": args.batch, "steps": args.steps, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "by_class_ms": by_class,
                      "top": [[a.key[:80], a.device_time_total / 1e3, a.count] for a in top[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
