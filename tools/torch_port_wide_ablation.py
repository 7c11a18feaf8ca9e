#!/usr/bin/env python3
"""What holds the wide conv core back: ablations of ``csrc/conv_wgmma_wide.cuh``.

    python3 tools/torch_port_wide_ablation.py [--rounds 3] [--out DIR]

Builds ``csrc/block_chain_wgmma.cu`` (the bf16 chain at C = 64-256) once
as it is and once per variant below, each from a patched copy of the
sources under ``build/ablation/``, all in parallel; then times the bf16
chain (``block_chain3``: the h1 pass and three wide-core convs) at each
shape of ``chip_smoke.WIDE_SHAPES`` under every build in turns, ``--rounds``
rounds of CUDA events over 10 calls, and prints the medians. Variants:

- ``no_weight_loads``: each weight slab's TMA load is skipped (its barrier
  is arrived on instead), so the products read stale weights: the time the
  weight stream from L2 costs;
- ``no_residual_wait``: the residual rows are not loaded and the epilogue
  does not wait for the previous store to release the staging row: what a
  residual costs (the stored values are wrong);
- ``wstages5``: five weight slabs in the ring instead of four (a design
  alternative; results stay right and are checked).

Only ``base`` and ``wstages5`` compute the right result; the others are
timing probes and are not checked. Needs one CUDA device and nvcc; run from
the root of the repository.
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

WIDE = "conv_wgmma_wide.cuh"
# variant -> [(text in conv_wgmma_wide.cuh, its replacement)]; each text must occur once
VARIANTS = {
    "base": [],
    "no_weight_loads": [(
        "    mbar_expect(&wfull[s], SLAB_BYTES);\n"
        "    tma_load(&tw, sw + s * SLAB_BYTES, &wfull[s], 64 * (r / 3), (item_of(q / S) % KS) * 64, 3 * (r % 3), 0);",
        "    mbar_arrive(&wfull[s]);")],
    "no_residual_wait": [(
        "    mbar_expect(&bar_res[wg], NRES * OUT_BYTES);\n"
        "    tma_load(&tres0, out, &bar_res[wg], n0, x0, y0 + wg, b);\n"
        "    if constexpr (NRES > 1) tma_load(&tres1, res1, &bar_res[wg], n0, x0, y0 + wg, b);",
        "    mbar_arrive(&bar_res[wg]);"), (
        "      if (leader && j + 1 < n) {\n        bulk_wait_read<0>();\n        load_res(j + 1);",
        "      if (leader && j + 1 < n) {\n        load_res(j + 1);")],
    "wstages5": [("constexpr int WSTAGES = 4;", "constexpr int WSTAGES = 5;")],
}


def build(out_dir: Path) -> dict[str, Path]:
    """One library of block_chain_wgmma.cu per variant, compiled in parallel."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    procs = {}
    for name, patches in VARIANTS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        text = (src / WIDE).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to patch is not in {WIDE} once: {old[:60]!r}")
            text = text.replace(old, new)
        (src / WIDE).write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / "block_chain_wgmma.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{log}")
        libs[name] = lib
    return libs


def use(lib: Path) -> None:
    """Route the wrappers' block_chain_wgmma functions to ``lib``."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    _build._libs["block_chain_wgmma"] = ctypes.CDLL(str(lib))
    for fn in ("dgmsr_h1", "dgmsr_chain3_wgmma", "dgmsr_stem_h1"):
        _build._fns.pop(fn, None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    from chip_smoke import BF16_TOL, WIDE_SHAPES, card_line, chain_inputs, cuda_ms, rel_err
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    _build.build_all()  # the other libraries, as the wrappers load them
    libs = build(ROOT / "build" / "ablation")
    res, failures = {}, []
    for b, c, h, w in WIDE_SHAPES:
        chain_args, _ = chain_inputs(b, c, h, w, torch.bfloat16, "cuda", seed=c + h)
        want = bc.block_chain3_plain(*chain_args)
        times = {name: [] for name in libs}
        for name in ("base", "wstages5"):
            use(libs[name])
            _, rel = rel_err(bc.block_chain3(*chain_args), want)
            if rel > BF16_TOL:
                failures.append(f"{name} at {(b, c, h, w)}: rel {rel:.3e}")
        for _ in range(args.rounds):
            for name in libs:
                use(libs[name])
                times[name].append(cuda_ms(lambda: bc.block_chain3(*chain_args)))
        med = {name: statistics.median(t) for name, t in times.items()}
        res[str((b, c, h, w))] = {"median_ms": med, "ms": times}
        print(f"{(b, c, h, w)}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
              + f" (medians of {args.rounds} rounds in turns)", flush=True)
        del chain_args, want
    line = {"card": card, "rounds": args.rounds, "shapes": res, "failures": failures}
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "wide_ablation.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
