#!/usr/bin/env python3
"""Where the time of one serve goes on the GPU (the PyTorch port).

    python3 tools/torch_port_profile.py [--model srdiff|sd] [--config default|A|B|C] [--batch N] [--steps 20]
                                        [--lr PX] [--out DIR]

``--model srdiff`` (default) serves the default full-width SRDiff config
(seeded random weights, bf16, DDIM ``--steps`` steps with eta 1, batch
``--batch`` (8) of 128x128 uint8 LR -> 512x512) under the kernel switches
of ``--config`` (``chip_smoke.CONFIGS``: the defaults, A, B or C). ``--model sd`` serves the SD
x4-upscaler at the published widths (seeded random weights, bf16, DDIM
``--steps`` steps with eta 0, guidance 9, noise level 20, batch ``--batch``
(1) of ``--lr``-square (256) uint8 LR -> x4). Each serves once to warm up,
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
    if any(k in name for k in ("conv_tile_kernel", "conv_wgmma_kernel", "stem_kernel", "h1_kernel",
                               "conv_stream_kernel", "chain_wide_kernel")):
        return "port kernels (convs and regions)"
    if "flash_kernel" in name:
        return "port kernel (flash attention)"
    if name.startswith("gn_") or "gn_stats" in name or "gn_apply" in name:
        return "port kernel (group norm)"
    low = name.lower()
    if any(k in low for k in ("xmma", "implicit_gemm", "cudnn", "cutlass", "conv", "gemm", "sm90")):
        return "cuDNN / cuBLAS convs and matmuls"
    return "elementwise, copies and other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("srdiff", "sd"), default="srdiff")
    ap.add_argument("--config", choices=("default", "A", "B", "C"), default="default",
                    help="SRDiff kernel switches (chip_smoke.CONFIGS)")
    ap.add_argument("--batch", type=int, default=None, help="images per serve (srdiff 8, sd 1)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=int, default=None, help="LR side in pixels (srdiff 128, sd 256)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    from chip_smoke import CONFIGS, switches

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    with switches(**CONFIGS[args.config]):
        return profile_serve(args)


def profile_serve(args) -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sd = args.model == "sd"
    batch = args.batch or (1 if sd else 8)
    lr = args.lr or (256 if sd else 128)
    imgs = np.random.default_rng(0).integers(0, 256, (batch, lr, lr, 3), dtype=np.uint8)
    if sd:
        from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

        pipe = StableDiffusionUpscalePipeline(seed=0)
        serve = lambda: pipe.upscale_device("a photo of a cat", imgs, num_inference_steps=args.steps)  # noqa: E731
    else:
        from dgm_img_super_resolution_tpu_torch.core.config import Hparams
        from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

        hp = Hparams(sampler="ddim", sample_timesteps=args.steps, ddim_eta=1.0, compute_dtype="bfloat16")
        pipe = SRDiffPipeline(hp)
        serve = lambda: pipe.upscale_batch_device(imgs, as_uint8=True)  # noqa: E731
    serve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.device_time_total for a in kernels) / 1e3
    by_class: dict[str, float] = {}
    for a in kernels:
        c = kernel_class(a.key)
        by_class[c] = by_class.get(c, 0.0) + a.device_time_total / 1e3
    card = torch.cuda.get_device_name(0)
    print(f"{card}: {args.model} config {args.config} batch {batch} LR {lr}, ddim{args.steps}: wall {wall_ms:.1f} ms (profiled), "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel names")
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:36s} {ms:9.1f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f}% of device time")
    top = sorted(kernels, key=lambda a: -a.device_time_total)[:20]
    for a in top:
        print(f"  {a.device_time_total / 1e3:9.2f} ms  x{a.count:<5d} {a.key[:110]}")
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / f"torch_port_profile_{args.model}_{args.config}.json"))
    print(json.dumps({"card": card, "model": args.model, "config": args.config, "batch": batch, "lr": lr, "steps": args.steps,
                      "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "by_class_ms": by_class,
                      "top": [[a.key[:80], a.device_time_total / 1e3, a.count] for a in top[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
