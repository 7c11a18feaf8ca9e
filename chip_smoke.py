#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (SRDiff x4 and SD x4-upscaler serving) on one NVIDIA GPU.

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
5. Hold the flash-attention kernel against its plain version: bf16 at the SD
   path's shape (2, 1024, 8, 128), float32 at a ragged L=1089 and at D=64;
   time it beside its plain version and ``F.scaled_dot_product_attention``
   (the yardstick only; the port never calls it).
6. Serve the SD x4-upscaler at the published widths (seeded random weights,
   bf16, DDIM 20 steps eta 0, guidance 9, noise level 20): one 256x256
   uint8 image -> (1, 1024, 1024, 3), where the flash kernel runs 120 times
   (6 level-3 and mid self-attentions of 1024 tokens per UNet call), then
   the app's 128x128 point -> (1, 512, 512, 3), where it runs 0 times.
   Each size is warmed up with a 2-step serve; the launch counters are set
   to 0 just before each timed serve and read just after.
7. The published-width UNet in float32 on the card and on the CPU at latent
   32x32 (plain attention), and one level-3 Transformer2D on 32x32 tokens
   (the flash kernel on the card, its plain version on the CPU).

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
# Flash attention against its plain version, relative to max |plain| alone
# (outputs are convex mixes of v). bf16: the kernel rounds p to bf16 against
# the running max of each 64-key tile, the plain version against the row max.
FLASH_SHAPE = (2, 1024, 8, 128)  # (B, L, H, D): CFG batch, level-3 tokens at LR 256, 8 heads of 128
FLASH_F32_SHAPES = ((1, 1089, 8, 128), (2, 1024, 4, 64), (1, 70, 2, 64))  # ragged L, D=64, one short tile
SD_PROMPT = "a photo of a cat, high resolution, detailed"


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
            # the plain version is a composition of cuDNN calls and
            # elementwise ops: no single PyTorch call computes the region
            "library_ms": None,
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


def flash_inputs(b, l, h, d, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, l, h, d, generator=g).to("cuda", dtype) for _ in range(3)]


def phase_flash():
    """The flash-attention kernel against its plain version; returns its
    table row (``launches`` filled by the SD serve) and failures."""
    import torch
    import torch.nn.functional as F

    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    for shape in FLASH_F32_SHAPES:
        q, k, v = flash_inputs(*shape, torch.float32, seed=shape[1])
        want = fa.flash_attention_reference(q, k, v)
        err = (fa.flash_attention(q, k, v) - want).abs().max().item()
        ok = err <= F32_TOL * want.abs().max().item()
        print(f"f32  flash_attention     {shape}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'} (tol {F32_TOL} of max |plain|)", flush=True)
        if not ok:
            failures.append(f"flash_attention f32 {shape}")
    b, l, h, d = FLASH_SHAPE
    q, k, v = flash_inputs(b, l, h, d, torch.bfloat16, seed=1)
    want = fa.flash_attention_reference(q, k, v)
    err = (fa.flash_attention(q, k, v).float() - want.float()).abs().max().item()
    ok = err <= BF16_TOL * want.float().abs().max().item()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=50)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, L, D), as views
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=50)
    flops, nbytes = 4.0 * b * h * l * l * d, 4 * b * l * h * d * 2
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
    print(f"bf16 flash_attention     {FLASH_SHAPE}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'} "
          f"(tol {BF16_TOL} of max |plain|); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB", flush=True)
    if not ok:
        failures.append("flash_attention bf16 main shape")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "dgm_img_super_resolution_tpu_torch/ops/kernels/csrc/flash_attention.cu",
           "replaces": "dgm_img_super_resolution_tpu/ops/pallas/attention.py:59",
           "launches": None, "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_ms}
    return row, failures


def _counters():
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    return {"block_chain3_stem": bc.block_chain3_stem, "block_chain3": bc.block_chain3,
            "tail_fuse": tf.tail_fuse, "flash_attention": fa.flash_attention}


def _sd_serve(pipe, lr: int, steps: int):
    """One timed SD serve of a ``lr``-square uint8 image with every launch
    counter set to 0 just before it; (output, seconds, launches)."""
    import numpy as np
    import torch

    img = np.random.default_rng(lr).integers(0, 256, (lr, lr, 3), dtype=np.uint8)
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = pipe.upscale_device(SD_PROMPT, img, num_inference_steps=steps, guidance_scale=9.0,
                              noise_level=20, eta=0.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {name: fn.launches for name, fn in counters.items()}


def phase_sd_serve(rows):
    """The SD x4-upscaler at the published widths in bf16: LR 256 (the flash
    kernel's path), then the app's LR 128, each timed once after a short
    warm-up serve. Fills the flash row's ``launches`` from the LR 256 serve."""
    import torch

    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    t0 = time.perf_counter()
    pipe = StableDiffusionUpscalePipeline(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    failures, res = [], {"init_s": init_s}
    steps = 20
    for lr, want_flash in ((256, 6 * steps), (128, 0)):
        _sd_serve(pipe, lr, 2)  # warm-up at this size (first-call set-up of its convs and matmuls)
        torch.cuda.reset_peak_memory_stats()
        out, dt, launches = _sd_serve(pipe, lr, steps)
        shape_ok = tuple(out.shape) == (1, 4 * lr, 4 * lr, 3) and out.is_cuda
        finite = bool(torch.isfinite(out).all())
        in_range = bool(((out >= 0) & (out <= 1)).all())
        if not (shape_ok and finite and in_range):
            failures.append(f"SD LR {lr}: output {tuple(out.shape)} finite {finite} in [0, 1] {in_range}")
        if launches["flash_attention"] != want_flash:
            failures.append(f"SD LR {lr}: flash_attention launched {launches['flash_attention']} times, "
                            f"expected {want_flash}")
        r = {"wall_s": dt, "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "out_mean": float(out.mean()), "out_std": float(out.std())}
        # one CFG UNet call and one decode at this size, on the serve's own shapes
        lat = torch.randn(2, 7, lr, lr, device="cuda", dtype=pipe.dtype)
        ctx = torch.randn(2, 77, 1024, device="cuda", dtype=pipe.dtype)
        tt, nl = torch.full((2,), 951, device="cuda"), torch.full((2,), 20, device="cuda")
        with torch.inference_mode():
            r["unet_step_ms"] = cuda_ms(lambda: pipe.unet(lat, tt, ctx, nl), iters=5)
            r["vae_decode_ms"] = cuda_ms(lambda: pipe.vae.decode(lat[:1, :4]), iters=2)
        if lr == 256:
            for row in rows:
                row["launches"] = launches[row["name"]]
        res[f"lr{lr}"] = r
        print(f"SD x4 ddim{steps} eta 0 cfg 9 bf16 LR {lr} -> {4 * lr}: {dt:.3f} s, UNet step (CFG batch 2) "
              f"{r['unet_step_ms']:.2f} ms, VAE decode {r['vae_decode_ms']:.2f} ms, peak {r['peak_mem_gib']:.2f} GiB, "
              f"launches {launches}, out mean {r['out_mean']:.4f} std {r['out_std']:.4f}"
              + ("" if shape_ok and finite and in_range else " FAIL"), flush=True)
    print(f"SD pipeline init (published widths, random weights on the card): {init_s:.2f} s", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return res, failures


def phase_sd_card_vs_cpu():
    """The published-width UNet in float32 on the card and on the CPU at
    latent 32x32 (plain attention: level 3 is 4x4), and its first level-3
    Transformer2D on 32x32 tokens (the flash kernel on the card)."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_UNET_CONFIG
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import init_sd_params
    from dgm_img_super_resolution_tpu_torch.models.sd.unet import UNet2DCondition
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = UNet2DCondition(X4_UNET_CONFIG).eval()
    init_sd_params(cpu, seed=3)
    with torch.device("cuda"):
        gpu = UNet2DCondition(X4_UNET_CONFIG).eval()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    x, ctx = torch.randn(2, 7, 32, 32, generator=g), torch.randn(2, 77, 1024, generator=g)
    t, nl = torch.tensor([951, 1]), torch.tensor([20, 350])
    res, failures = {}, []
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu(x, t, ctx, nl)
        cpu_s = time.perf_counter() - t0
        got = gpu(x.cuda(), t.cuda(), ctx.cuda(), nl.cuda()).cpu()
        err, rel = rel_err(got, want)
        # F32_TOL as for the SRDiff UNet forward: float32 sums in another
        # order (cuDNN's algorithms, TF32 off) through about 70 layers
        ok = rel <= F32_TOL and bool(torch.isfinite(got).all())
        print(f"card vs CPU, f32 SD UNet published widths, latent 32x32 B=2: max_abs_err {err:.3e} "
              f"rel {rel:.3e} {'ok' if ok else 'FAIL'} (tol {F32_TOL}; CPU {cpu_s:.1f} s)", flush=True)
        res["unet"] = {"max_abs_err": err, "rel_err": rel, "cpu_s": cpu_s}
        if not ok:
            failures.append("SD card vs CPU UNet forward")

        tcpu, tgpu = cpu.down_blocks[3].attentions[0], gpu.down_blocks[3].attentions[0]
        y = torch.randn(2, tcpu.proj_in.in_features, 32, 32, generator=g)
        want = tcpu(y, ctx)
        before = fa.flash_attention.launches
        got = tgpu(y.cuda(), ctx.cuda()).cpu()
        n = fa.flash_attention.launches - before
        err, rel = rel_err(got, want)
        ok = rel <= F32_TOL and n == 1
        print(f"card vs CPU, f32 level-3 Transformer2D (1024 ch, 8 heads) on 32x32 tokens B=2: "
              f"max_abs_err {err:.3e} rel {rel:.3e}, flash launches {n} {'ok' if ok else 'FAIL'} "
              f"(tol {F32_TOL})", flush=True)
        res["transformer2d"] = {"max_abs_err": err, "rel_err": rel, "flash_launches": n}
        if not ok:
            failures.append("SD card vs CPU Transformer2D")
    del cpu, gpu
    torch.cuda.empty_cache()
    return res, failures


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
    flash_row, f5 = phase_flash()
    rows.append(flash_row)
    sd, f6 = phase_sd_serve([flash_row])
    sd_e2e, f7 = phase_sd_card_vs_cpu()
    failures += f3 + f4 + f5 + f6 + f7
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "pipeline": pipe, "card_vs_cpu": e2e, "sd": sd,
             "sd_card_vs_cpu": sd_e2e, "failures": failures}, indent=1))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
