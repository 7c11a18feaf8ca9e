#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SRDiff x4 serving on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository; it needs one CUDA device and nvcc.

1. Print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build the hand-written kernels from
   ``dgm_img_super_resolution_tpu_torch/ops/kernels/csrc``.
2. Hold each kernel against its plain PyTorch version on the card: in bf16
   at the main path's shapes (batch 8, 512x512 HR), and in float32 with TF32
   off at edge shapes; time both with CUDA events.
3. Serve the default full-width config (hidden 64, mults 1|2|3|4, RRDB nb 8,
   seeded random weights) with DDIM 20 steps, eta 1, bf16: batch 8 of
   128x128 uint8 -> (8, 512, 512, 3) uint8. The kernels' launch counters are
   set to 0 just before the timed batch and read just after.
4. Run the full-width model in float32 at LR 32x32 on the card (kernels) and
   on the CPU (plain versions) with the same weights and injected noise.

Any failure exits non-zero. The line before the last is the kernel table
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
``--out DIR`` also writes the full results and the compiler's resource
reports there.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
HBM_BPS = 3.35e12    # H100 SXM HBM3 bytes/s
BF16_TOL = 3e-2      # max |kernel - plain| / max(1, max |plain|) in bf16
F32_TOL = 1e-4       # the same in float32 (TF32 off on both sides)
# Card vs CPU, float32 SR output in [0, 1]. The first DDIM step (t=99 of the
# cosine T=100 schedule) maps eps to x0 through sqrt((1 - a_t) / a_t) ~ 65,
# and the output is x / 2 + the bicubic LR, so an eps difference d reaches
# the output as up to ~32 d. Float32 sum-order differences in eps are held
# at F32_TOL on one UNet forward; with eps of the random-weight model a few
# units large they come to ~1e-5, and this bound leaves 3x room over ~32x
# that. A broken kernel moves the output by 1e-1 or more.
E2E_TOL = 1e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max(1, max |b|))."""
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(1.0, b.float().abs().max().item())


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


class Regions:
    """Random inputs for the three kernel regions at one shape and dtype,
    with their FLOP and byte counts."""

    def __init__(self, b, h, w, dtype, device, seed=0):
        import torch

        g = torch.Generator().manual_seed(seed)
        c = 64
        self.dtype = dtype

        def act(*shape, scale=1.0):
            t = torch.randn(shape, generator=g) * scale
            return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)

        def param(*shape, fan_in=None, scale=None):
            s = scale if scale is not None else 1.0 / fan_in**0.5
            return (torch.randn(shape, generator=g) * s).to(device)

        def vec(*shape, scale):
            return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dtype)

        convw = lambda: param(c, c, 3, 3, fan_in=9 * c)  # noqa: E731
        bias = lambda: param(c, scale=0.1)  # noqa: E731
        esize = torch.finfo(dtype).bits // 8
        # block_chain3_stem at (b, h, w)
        self.stem = (act(b, 3, h, w), param(c, 3, 3, 3, fan_in=27), bias(), param(c, 3, 1, 1, fan_in=3),
                     bias(), vec(b, c, scale=0.5), vec(b, c, scale=0.5), convw(), bias(), convw(), bias(),
                     convw(), bias(), act(b, c, h, w))
        self.stem_work = (2.0 * b * h * w * (27 * c + 3 * c + 27 * c * c),
                          esize * b * h * w * (3 + 2 * c) + 4 * (30 * c + 27 * c * c))
        # block_chain3 at (b, h/2, w/2), no cond (the last up stage)
        h2, w2 = h // 2, w // 2
        self.chain = (act(b, c, h2, w2), act(b, c, h2, w2), vec(b, c, scale=0.5), vec(b, c, scale=0.5),
                      convw(), bias(), convw(), bias(), convw(), bias())
        self.chain_work = (2.0 * b * h2 * w2 * 27 * c * c, esize * b * h2 * w2 * 3 * c + 4 * 27 * c * c)
        # tail_fuse: (b, c, h/2, w/2) -> (b, 3, h, w)
        self.tail = (act(b, c, h2, w2), param(c, c, 4, 4, fan_in=4 * c), bias(), convw(), bias(),
                     param(3, c, 1, 1, fan_in=c), param(3, scale=0.1))
        self.tail_work = (2.0 * b * h * w * (4 * c * c + 9 * c * c + 3 * c),
                          esize * (b * h2 * w2 * c + b * h * w * 3) + 4 * (25 * c * c + 3 * c))


def phase_build(out_dir):
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {sorted(libs)}", flush=True)
    for path in libs.values():
        log = Path(f"{path}.log")
        if log.exists():
            report = [ln for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
            print("\n".join(f"  ptxas {path.name}: {ln.strip()}" for ln in report[:12]), flush=True)
            if out_dir:
                shutil.copy(log, out_dir / log.name)


def phase_kernels():
    """Each kernel against its plain version; returns the table rows."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = {
        "block_chain3_stem": (bc.block_chain3_stem, bc.block_chain3_stem_plain, "stem",
                              "dgm_img_super_resolution_tpu_torch/ops/kernels/csrc/block_chain.cu",
                              "dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:733"),
        "block_chain3": (bc.block_chain3, bc.block_chain3_plain, "chain",
                         "dgm_img_super_resolution_tpu_torch/ops/kernels/csrc/block_chain.cu",
                         "dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:311"),
        "tail_fuse": (tf.tail_fuse, tf.tail_fuse_plain, "tail",
                      "dgm_img_super_resolution_tpu_torch/ops/kernels/csrc/tail_fuse.cu",
                      "dgm_img_super_resolution_tpu/ops/pallas/tail_fuse.py:281"),
    }
    rows, failures = [], []
    # float32 at edge shapes: batch 1 at 8x8 and 40x72, and a ragged batch 2
    # (H, W not multiples of the 8x16 tile) -- the sizes are the HR sizes.
    for b, h, w in ((1, 8, 8), (1, 40, 72), (2, 26, 38)):
        r = Regions(b, h, w, torch.float32, "cuda", seed=h * w)
        for name, (kern, plain, attr, *_rest) in fns.items():
            args = getattr(r, attr)
            err, rel = rel_err(kern(*args), plain(*args))
            ok = rel <= F32_TOL
            print(f"f32  {name:18s} B={b} {h}x{w}: max_abs_err {err:.3e} rel {rel:.3e} "
                  f"{'ok' if ok else 'FAIL'} (tol {F32_TOL})", flush=True)
            if not ok:
                failures.append(f"{name} f32 {b}x{h}x{w}")
    # bf16 at the main path's shapes
    r = Regions(8, 512, 512, torch.bfloat16, "cuda", seed=1)
    for name, (kern, plain, attr, source, replaces) in fns.items():
        args = getattr(r, attr)
        err, rel = rel_err(kern(*args), plain(*args))
        ok = rel <= BF16_TOL
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        flops, nbytes = getattr(r, f"{attr}_work")
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        print(f"bf16 {name:18s} main shape: max_abs_err {err:.3e} rel {rel:.3e} "
              f"{'ok' if ok else 'FAIL'} (tol {BF16_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by}); {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB",
              flush=True)
        if not ok:
            failures.append(f"{name} bf16 main shape")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # the plain version is a composition of cuDNN calls; no single
            # PyTorch call computes the region, so it doubles as the yardstick
            "library_ms": plain_ms,
        })
    del r
    torch.cuda.empty_cache()
    return rows, failures


def phase_pipeline(rows):
    """Full-width ddim20 serve in bf16; fills each row's ``launches``."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    hp = Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype="bfloat16")
    pipe = SRDiffPipeline(hp)
    imgs = np.random.default_rng(0).integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    counters = {"block_chain3_stem": bc.block_chain3_stem, "block_chain3": bc.block_chain3,
                "tail_fuse": tf.tail_fuse}
    pipe.upscale_batch_device(imgs, as_uint8=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = pipe.upscale_batch_device(imgs, as_uint8=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    failures = []
    if tuple(out.shape) != (8, 512, 512, 3) or out.dtype != torch.uint8 or not out.is_cuda:
        failures.append(f"pipeline output {tuple(out.shape)} {out.dtype} {out.device}")
    for name, n in launches.items():
        if n != 20:
            failures.append(f"{name} launched {n} times in a 20-step batch")
    for row in rows:
        row["launches"] = launches[row["name"]]
    lat = []
    for _ in range(5):
        t1 = time.perf_counter()
        one = pipe.upscale_batch_device(imgs[:1])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
    if tuple(one.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(one).all()):
        failures.append("batch-1 output not finite or of the wrong shape")
    res = {"img_per_s": 8 / dt, "batch8_s": dt, "batch1_latency_s": sorted(lat)[2],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           "out_mean": float(out.float().mean())}
    print(f"pipeline ddim20 eta=1 bf16 B=8 128->512: {res['img_per_s']:.2f} img/s "
          f"({dt:.3f} s/batch), batch-1 latency {res['batch1_latency_s']:.3f} s, "
          f"peak {res['peak_mem_gib']:.2f} GiB, launches {launches}", flush=True)
    return res, failures


def phase_card_vs_cpu():
    """The full-width model in float32 on the card (kernels) and on the CPU
    (plain versions), same weights: one UNet forward on the same inputs,
    then the whole serve (DDIM 4 steps, eta 1) with the same injected
    noise."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = Hparams(sampler="ddim", sample_timesteps=4, ddim_eta=1.0, compute_dtype="float32")
    cpu = SRDiffPipeline(hp, device="cpu")
    gpu = SRDiffPipeline(hp, params=cpu.model.state_dict())
    g = torch.Generator().manual_seed(2)
    shape = (2, 3, 128, 128)

    x, cond = torch.randn(shape, generator=g), torch.randn(2, 96, 32, 32, generator=g)
    t = torch.tensor([99, 33])
    with torch.inference_mode():
        eps_ref = cpu.model.denoise_fn(x, t, cond)
        eps = gpu.model.denoise_fn(x.cuda(), t.cuda(), cond.cuda()).cpu()
    eps_err, eps_rel = rel_err(eps, eps_ref)

    imgs = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ts, _ = cpu.model.ddim_timesteps(4)
    noise = (torch.randn(shape, generator=g), {t: torch.randn(shape, generator=g) for t in ts})
    t0 = time.perf_counter()
    ref = cpu.upscale_batch(imgs, noise=noise)
    t_cpu = time.perf_counter() - t0
    got = gpu.upscale_batch(imgs, noise=noise)
    err = float(np.abs(got - ref).max())
    ok_eps = eps_rel <= F32_TOL
    ok = err <= E2E_TOL and bool(np.isfinite(got).all())
    print(f"card vs CPU, f32 full width, one UNet forward B=2 128x128: max_abs_err {eps_err:.3e} "
          f"rel {eps_rel:.3e} {'ok' if ok_eps else 'FAIL'} (tol {F32_TOL})", flush=True)
    print(f"card vs CPU, f32 full width, serve B=2 32->128 ddim4 eta 1: max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'} (tol {E2E_TOL}; CPU run {t_cpu:.1f} s)", flush=True)
    failures = ([] if ok_eps else ["card vs CPU UNet forward"]) + ([] if ok else ["card vs CPU serve"])
    return {"eps_max_abs_err": eps_err, "eps_rel_err": eps_rel, "max_abs_err": err, "cpu_s": t_cpu}, failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="directory for the full results")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import dgm_img_super_resolution_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 1
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    phase_build(args.out)
    rows, failures = phase_kernels()
    pipe, f3 = phase_pipeline(rows)
    e2e, f4 = phase_card_vs_cpu()
    failures += f3 + f4
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "pipeline": pipe, "card_vs_cpu": e2e,
             "failures": failures}, indent=1))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
