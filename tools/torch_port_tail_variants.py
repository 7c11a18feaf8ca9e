#!/usr/bin/env python3
"""Design probes of the bf16 tail's second launch, the 3x3 + Mish + 1x1 on the
conv core (``csrc/tail_fuse_wgmma.cu``: the core's reflect conv with the
``Tail`` hook).

    python3 tools/torch_port_tail_variants.py [--rounds 3]

Builds ``csrc/tail_fuse_wgmma.cu`` once as it is and once per variant below,
each from a patched copy of the sources under ``build/tail_variants/``, all
in parallel, and prints each build's ptxas report (registers, spills). Then
holds each build's second launch (``tail_fuse._launch_conv_mish_1x1``)
against its plain piece at the main path's shape, y (8, 64, 512, 512) with
cout 3, and times the builds in turns: ``--rounds`` rounds of CUDA events
over 10 calls each, medians. Variants of the hook's epilogue (the
source's: the bias in registers, the bf16 1x1 weights read from L1):

- ``bias_ldg``: the bias read from L1 in the epilogue too, instead of held
  in 16 registers for the kernel's life (``BiasRegs``);
- ``no_mish`` and ``no_1x1``: timing probes with Mish, or the 1x1's FMAs
  and weight loads, taken out: what each costs. Their results are wrong and
  are not checked; the others compute the same function and are.

Needs one CUDA device and nvcc; run from the root of the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = "tail_fuse_wgmma.cu"
FMAS = "for (int o = 0; o < CO; ++o) s[h][o] = fmaf(m.y, w[CO + o], fmaf(m.x, w[o], s[h][o]));"
# variant -> [(text in tail_fuse_wgmma.cu, its replacement)], applied in order; each text must occur once
VARIANTS = {
    "base": [],
    "bias_ldg": [
        ("  using Regs = BiasRegs;\n  __device__ __forceinline__ Regs setup(int t, int) const { return bias_regs(bias, t); }",
         "  struct Regs {};\n  __device__ __forceinline__ Regs setup(int, int) const { return {}; }"),
        ("void store(const Regs& r, const float", "void store(const Regs&, const float"),
        ("unpack(pack(acc[4 * n + 2 * h] + r.b[2 * n], acc[4 * n + 2 * h + 1] + r.b[2 * n + 1]))",
         "unpack(pack(acc[4 * n + 2 * h] + __ldg(bias + 8 * n + 2 * t),\n"
         "                                     acc[4 * n + 2 * h + 1] + __ldg(bias + 8 * n + 2 * t + 1)))")],
    "no_mish": [("const float2 m = unpack(pack(mish(v.x), mish(v.y)));", "const float2 m = v;")],
    "no_1x1": [(FMAS, "s[h][0] += m.x + m.y;")],
}
PROBES = ("no_mish", "no_1x1")  # timing probes: their results are wrong and not checked


def build(out_dir: Path) -> tuple[dict[str, Path], dict[str, str]]:
    """One library of tail_fuse_wgmma.cu per variant, compiled in parallel;
    the libraries and their compiler logs."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    procs = {}
    for name, patches in VARIANTS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        text = (src / SRC).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to patch is not in {SRC} once: {old[:60]!r}")
            text = text.replace(old, new)
        (src / SRC).write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / SRC)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{log}")
        libs[name], logs[name] = lib, log
    return libs, logs


def use(lib: Path) -> None:
    """Route the tail's core functions to ``lib``."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    _build._libs["tail_fuse_wgmma"] = ctypes.CDLL(str(lib))
    for fn in ("dgmsr_convt_wgmma", "dgmsr_conv_mish_1x1_wgmma"):
        _build._fns.pop(fn, None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    from chip_smoke import BF16_TOL, Regions, card_line, cuda_ms, ptxas_report, rel_err
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    libs, logs = build(ROOT / "build" / "tail_variants")
    for name, log in logs.items():
        for ln in ptxas_report(log):
            print(f"  ptxas {name}: {ln}", flush=True)
    x, wt, bt, wf, bf, wo, bo = Regions(8, 512, 512, torch.bfloat16, "cuda", seed=1).tail
    y = tf.convt_plain(x, wt, bt)
    want = tf.conv_mish_1x1_plain(y, wf, bf, wo, bo)
    fn = lambda: tf._launch_conv_mish_1x1(y, wf, bf, wo, bo)  # noqa: E731
    failures, times = [], {name: [] for name in libs}
    for name, lib in libs.items():
        if name in PROBES:
            continue
        use(lib)
        _, rel = rel_err(fn(), want)
        print(f"{name}: rel err {rel:.3e} {'ok' if rel <= BF16_TOL else 'FAIL'} (tol {BF16_TOL})", flush=True)
        if rel > BF16_TOL:
            failures.append(name)
    for _ in range(args.rounds):
        for name, lib in libs.items():
            use(lib)
            times[name].append(cuda_ms(fn))
    for name, ts in times.items():
        print(f"{name}: 3x3 + Mish + 1x1 at y {tuple(y.shape)} {statistics.median(ts):.4f} ms "
              f"({min(ts):.4f}-{max(ts):.4f}, {args.rounds} rounds in turns)", flush=True)
    print(json.dumps({"card": card, "ms": times, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
