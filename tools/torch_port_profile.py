#!/usr/bin/env python3
"""Where the time of one serve, or of one training step, goes on the GPU
(the PyTorch port).

    python3 tools/torch_port_profile.py [--model srdiff|sd] [--config default|A|B|C] [--batch N] [--steps 20]
                                        [--enc-interval K] [--lr PX] [--top 20] [--out DIR]
    python3 tools/torch_port_profile.py --train [--config ...] [--batch 64] [--hr 160] [--top 20] [--out DIR]
    python3 tools/torch_port_profile.py --edu ae|vae|ddpm|gan|dcgan|wgan-gp|ddpm_sample [--batch N] [--top 20]
    (any of them with --eager)

``--model srdiff`` (default) serves the default full-width SRDiff config
(seeded random weights, bf16, DDIM ``--steps`` steps with eta 1, batch
``--batch`` (8) of 128x128 uint8 LR -> 512x512) under the kernel switches
of ``--config`` (``chip_smoke.CONFIGS``: the defaults, A, B or C). ``--model sd`` serves the SD
x4-upscaler at the published widths (seeded random weights, bf16, DDIM
``--steps`` steps with eta 0, guidance 9, noise level 20, batch ``--batch``
(1) of ``--lr``-square (256) uint8 LR -> x4). ``--enc-interval`` K > 1 serves
either with encoder propagation. Each serves once to warm up,
then once under ``torch.profiler``. Prints the device time by kernel class
and the ``--top`` kernels, the device's busy and idle share of the wall time, and
one JSON line with the same numbers. ``--out DIR`` also writes a Chrome trace.

``--train`` profiles one SRDiff training step instead (``Trainer.train_step``
of ``SRDiffTask``, full width, seeded random weights, bf16, batch
``--batch`` (64) of ``--hr`` (160) HR crops already in host memory, after
two warm-up steps) and splits its device time into: the forward's port
kernels (rows 1-3: they launch in the forward only), the backward's plain
recompute of the regions (every kernel launched under a
``RecomputeBackward`` node, ``ops/kernels/_autograd.py``), cuDNN / cuBLAS
and glue outside those, and the optimizer (clip, Adam, EMA: the
``optimizer_update`` range of the trainer).

``--edu`` profiles one float32 step of an educational task at the JAX
defaults' widths instead (``chip_smoke.phase_edu``'s: the AE, VAE or DDPM
``Trainer.train_step``, a GAN's whole round of ``GANTask.train_step``;
batch ``--batch``, 128 and the DDPM 64, on the card, after two warm-up
steps), or ``ddpm_sample``: 20 steps of the DDPM sampler at batch 16. It
prints the device time by kernel class, the busy share and the ``--top``
kernels.
The serves, the training steps and the GAN rounds replay their captured
CUDA graphs (``core/graphs.py``): the warm-up captures them, and the
profiled call is a replay, whose kernels run without the host's record
ranges, so that ``--train``'s split by range (the recompute, the
optimizer) reads 0 there. ``--eager`` profiles the eager path
(``graphs.eager()``) instead, warm-up included.
Needs one CUDA device and nvcc (``--edu`` needs no nvcc); run from the root of the repository.
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
                               "conv_stream_kernel", "chain_wide_kernel", "conv_wide_kernel", "convt_kernel",
                               "ds_kernel", "head_kernel")):
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
    ap.add_argument("--enc-interval", type=int, default=1, help="encoder propagation every K steps")
    ap.add_argument("--top", type=int, default=20, help="kernels listed by device time")
    ap.add_argument("--lr", type=int, default=None, help="LR side in pixels (srdiff 128, sd 256)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--train", action="store_true", help="profile one SRDiff training step")
    ap.add_argument("--hr", type=int, default=160, help="HR crop side of --train")
    ap.add_argument("--edu", choices=("ae", "vae", "ddpm", "gan", "dcgan", "wgan-gp", "ddpm_sample"), default=None,
                    help="profile one step of an educational task")
    ap.add_argument("--eager", action="store_true", help="the eager path instead of the captured graphs' replay")
    args = ap.parse_args()

    import contextlib

    import torch

    from chip_smoke import CONFIGS, switches
    from dgm_img_super_resolution_tpu_torch.core import graphs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    with graphs.eager() if args.eager else contextlib.nullcontext():
        print(f"path: {'eager' if args.eager else 'captured graphs, replayed'}", flush=True)
        if args.edu:
            return profile_edu(args)
        with switches(**CONFIGS[args.config]):
            return profile_train(args) if args.train else profile_serve(args)


def _subtree_kernels(evt, into: dict[str, float]) -> None:
    """Device ms by kernel class of every kernel launched under ``evt``."""
    for k in evt.kernels:
        c = kernel_class(k.name)
        into[c] = into.get(c, 0.0) + k.duration / 1e3
    for child in evt.cpu_children:
        _subtree_kernels(child, into)


def _ranges(events, match) -> list:
    """The outermost events whose name ``match`` accepts."""
    out = []
    for e in events:
        if not match(e.name):
            continue
        p = e.cpu_parent
        while p is not None and not match(p.name):
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return out


def profile_train(args) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import TRAIN_HP, _train_batch
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

    batch_n = args.batch or 64
    hp = Hparams(**dict(TRAIN_HP, batch_size=batch_n, patch_size=args.hr))
    trainer = SRDiffTask(hp).make_trainer()
    state = trainer.init_state()
    batch = _train_batch(batch_n, args.hr, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        trainer.train_step(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the trainer's record_function ranges show on the device timeline too; they are not kernels
    kernels = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA
               and a.key not in ("loss_and_grad", "optimizer_update") and not getattr(a, "is_user_annotation", False)]
    busy_ms = sum(a.device_time_total for a in kernels) / 1e3
    total: dict[str, float] = {}
    for a in kernels:
        c = kernel_class(a.key)
        total[c] = total.get(c, 0.0) + a.device_time_total / 1e3
    events = prof.events()
    recompute: dict[str, float] = {}
    for e in _ranges(events, lambda n: "RecomputeBackward" in n):
        _subtree_kernels(e, recompute)
    optim: dict[str, float] = {}
    for e in _ranges(events, lambda n: n == "optimizer_update"):
        _subtree_kernels(e, optim)
    port = "port kernels (convs and regions)"
    lib, glue = "cuDNN / cuBLAS convs and matmuls", "elementwise, copies and other"
    rest = lambda c: total.get(c, 0.0) - recompute.get(c, 0.0) - optim.get(c, 0.0)  # noqa: E731
    by_class = {
        "forward: port kernels (rows 1-3)": rest(port),
        "backward: plain recompute of the regions": sum(recompute.values()),
        "cuDNN / cuBLAS (forward and backward, outside the recompute)": rest(lib),
        "glue (elementwise, copies; outside the recompute and the optimizer)": rest(glue),
        "optimizer (clip, Adam, EMA)": sum(optim.values()),
    }
    card = torch.cuda.get_device_name(0)
    print(f"{card}: SRDiff train step config {args.config}, batch {batch_n} of {args.hr}^2 bf16: wall {wall_ms:.1f} ms "
          f"(profiled), device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel names")
    for c, ms in by_class.items():
        print(f"  {c:70s} {ms:9.1f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f}% of device time")
    print(f"  the recompute by class: {recompute}; the optimizer by class: {optim}")
    top = sorted(kernels, key=lambda a: -a.device_time_total)[:args.top]
    for a in top:
        print(f"  {a.device_time_total / 1e3:9.2f} ms  x{a.count:<5d} {a.key[:110]}")
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / f"torch_port_profile_train_{args.config}.json"))
    print(json.dumps({"card": card, "model": "srdiff_train", "config": args.config, "batch": batch_n, "hr": args.hr,
                      "wall_ms": wall_ms, "device_busy_ms": busy_ms, "by_class_ms": by_class,
                      "recompute_by_kernel_class_ms": recompute, "optimizer_by_kernel_class_ms": optim,
                      "top": [[a.key[:80], a.device_time_total / 1e3, a.count] for a in top[:10]]}))
    return 0


def profile_edu(args) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import EDU_DDPM_BATCH, EDU_BATCH, _edu_batch, _edu_loss_kw, _edu_task, _gan_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = "ddpm" if args.edu == "ddpm_sample" else args.edu
    task = _edu_task(kind, "cuda")
    n = args.batch or (16 if args.edu == "ddpm_sample" else EDU_DDPM_BATCH if kind == "ddpm" else EDU_BATCH)
    if kind in ("gan", "dcgan", "wgan-gp"):
        state = task.init_state(0)
        real = task._real(_edu_batch(kind, n, seed=3))
        draws = {k: v.cuda() for k, v in _gan_draws(task, n, seed=4).items()}

        def step():
            task.train_step(state, real, noise=draws)
    elif args.edu == "ddpm_sample":
        model = task.init_params(0).cuda()
        x = torch.randn(n, 1, 32, 32, device="cuda")

        def step():
            with torch.no_grad():
                for t in range(999, 979, -1):
                    model.p_sample_step(x, t, x)
    else:
        trainer = task.make_trainer("cuda")
        state = trainer.init_state(0)
        b = {"x": torch.from_numpy(_edu_batch(kind, n, seed=3)["x"]).cuda()}
        kw = _edu_loss_kw(kind, n, "cuda", seed=5)

        def step():
            trainer.train_step(state, b, None, **kw)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA
               and a.key not in ("loss_and_grad", "optimizer_update") and not getattr(a, "is_user_annotation", False)]
    busy_ms = sum(a.device_time_total for a in kernels) / 1e3
    launches = sum(a.count for a in kernels)
    by_class: dict[str, float] = {}
    for a in kernels:
        c = kernel_class(a.key)
        by_class[c] = by_class.get(c, 0.0) + a.device_time_total / 1e3
    card = torch.cuda.get_device_name(0)
    what = "20 sampler steps" if args.edu == "ddpm_sample" else "one step" if kind in ("ae", "vae", "ddpm") \
        else "one round"
    print(f"{card}: {args.edu} {what}, batch {n}, float32: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches")
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:40s} {ms:9.2f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f}% of device time")
    top = sorted(kernels, key=lambda a: -a.device_time_total)[:args.top]
    for a in top:
        print(f"  {a.device_time_total / 1e3:9.3f} ms  x{a.count:<5d} {a.key[:110]}")
    print(json.dumps({"card": card, "model": f"edu_{args.edu}", "batch": n, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "launches": launches, "by_class_ms": by_class,
                      "top": [[a.key[:80], a.device_time_total / 1e3, a.count] for a in top[:10]]}))
    return 0


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
        serve = lambda: pipe.upscale_device("a photo of a cat", imgs, num_inference_steps=args.steps,  # noqa: E731
                                            enc_interval=args.enc_interval)
    else:
        from dgm_img_super_resolution_tpu_torch.core.config import Hparams
        from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

        hp = Hparams(sampler="ddim", sample_timesteps=args.steps, ddim_eta=1.0, compute_dtype="bfloat16",
                     enc_interval=args.enc_interval)
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
    print(f"{card}: {args.model} config {args.config} batch {batch} LR {lr}, ddim{args.steps} enc_interval "
          f"{args.enc_interval}: wall {wall_ms:.1f} ms (profiled), "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel names")
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:36s} {ms:9.1f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f}% of device time")
    top = sorted(kernels, key=lambda a: -a.device_time_total)[:args.top]
    for a in top:
        print(f"  {a.device_time_total / 1e3:9.2f} ms  x{a.count:<5d} {a.key[:110]}")
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / f"torch_port_profile_{args.model}_{args.config}.json"))
    print(json.dumps({"card": card, "model": args.model, "config": args.config, "batch": batch, "lr": lr, "steps": args.steps,
                      "enc_interval": args.enc_interval,
                      "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "by_class_ms": by_class,
                      "top": [[a.key[:80], a.device_time_total / 1e3, a.count] for a in top[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
