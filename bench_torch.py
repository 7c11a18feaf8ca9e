"""Benchmark of the PyTorch port: SRDiff x4 super-resolution throughput and
latency on one CUDA card (counterpart of the repo's ``bench.py``, which
measures the JAX package).

The same requests in the same order as ``bench.py``, at 512x512 output:
bicubic x4 + RRDB encoder + the sampler, bf16 activations, uint8 out.

- The operating point (:func:`resolve_operating_point`): the recorded one
  of ``DDIM_OPERATING_POINT.json`` (ddim20, eta 1 without it);
  ``BENCH_SAMPLER``, ``BENCH_STEPS``, ``BENCH_ETA`` and ``BENCH_ENC``
  override it.
- ``BENCH_BATCH`` (8) LR images of 128x128 uint8 from
  ``np.random.default_rng(0)``; a warm-up serve (the first call of a shape
  runs eagerly and captures its CUDA graph); ``BENCH_ITERS`` (16) serves
  dispatched back to back and then fetched to the host (``value``);
  ``BENCH_LAT_ITERS`` (5) serves, each timed to device completion
  (``p50_latency_s``, ``p99_latency_s``); unless ``BENCH_FULL_CHAIN=0`` or
  the operating point already is the T=100 chain, the T=100 ancestral chain
  on the same weights, one warm-up and ``BENCH_FULL_ITERS`` (3) serves
  (``full_chain_value``); the batch-1 latency, one warm-up and
  ``BENCH_LAT_ITERS`` serves.
- Noise: the serve of ``jax.random.PRNGKey(i)`` in ``bench.py`` draws here
  from a generator on the device seeded ``i`` (0..15, 100 + i, 200 + i).
- The kernel switches of ``models/layers.py`` are read from the
  environment as on every path: ``DGMSR_CHAIN_C=64,128,192,256 python
  bench_torch.py`` measures configuration C.

Prints ONE JSON line with ``bench.py``'s keys, and ``device``: the card's
name and power limit (``nvidia-smi``), or ``cpu``. ``vs_baseline`` is
against the reference's ~15 s per image on a CPU, as in ``bench.py``.

Usage, from the root of a checkout: ``python bench_torch.py [--device D]``
or ``dgmsr-torch bench [--device D]``; the CUDA device by default, and with
none and no ``--device`` it raises (``--device cpu`` runs the plain
PyTorch versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.device import card_description, resolve_device
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.validation import recorded_operating_point

BASELINE_UPSCALES_PER_SEC = 1.0 / 15.0  # reference: ~15 s per image (CPU)
LR_SIZE = 128  # -> 512x512 output at x4


def resolve_operating_point(env=None, record_path=None) -> dict:
    """The benchmarked sampler mode: the operating point recorded in
    ``DDIM_OPERATING_POINT.json`` beside this file (or at ``record_path``),
    ddim20 eta 1 without one; ``BENCH_SAMPLER``, ``BENCH_STEPS``,
    ``BENCH_ETA`` and ``BENCH_ENC`` of ``env`` (``os.environ`` by default)
    override it."""
    env = os.environ if env is None else env
    op = recorded_operating_point(record_path or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "DDIM_OPERATING_POINT.json"))
    return {
        "sampler": env.get("BENCH_SAMPLER", op["sampler"]),
        "steps": int(env.get("BENCH_STEPS", str(op["steps"]))),
        "eta": float(env.get("BENCH_ETA", str(op.get("eta", 1.0)))),
        "enc_interval": int(env.get("BENCH_ENC", str(op.get("enc_interval", 1)))),
    }


def _sync(device: torch.device) -> None:
    """Wait for the device: where ``bench.py`` fetches a scalar of the batch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="", help="torch device; the CUDA device by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or None)

    op = resolve_operating_point()
    sampler, steps, eta, enc_interval = op["sampler"], op["steps"], op["eta"], op["enc_interval"]
    hp = Hparams(
        compute_dtype="bfloat16",
        sampler=sampler,
        sample_timesteps=steps if sampler == "ddim" else 0,
        ddim_eta=eta,
        enc_interval=enc_interval,
    )
    batch = int(os.environ.get("BENCH_BATCH", "8"))

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    pipe = SRDiffPipeline(hp, device=device)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (batch, LR_SIZE, LR_SIZE, 3), dtype=np.uint8)

    # warm-up: the eager first call and the capture of its graph
    out = pipe.upscale_batch_device(imgs, gen(0), as_uint8=True).cpu()
    assert tuple(out.shape) == (batch, 4 * LR_SIZE, 4 * LR_SIZE, 3), out.shape
    assert out.dtype == torch.uint8

    # throughput: every serve dispatched, then every result fetched, as a
    # server overlaps a batch's copy to the host with the next one's compute
    iters = int(os.environ.get("BENCH_ITERS", "16"))
    _sync(device)
    t0 = time.perf_counter()
    outs = [pipe.upscale_batch_device(imgs, gen(i), as_uint8=True) for i in range(iters)]
    outs = [o.cpu() for o in outs]
    dt = time.perf_counter() - t0
    assert tuple(outs[-1].shape) == (batch, 4 * LR_SIZE, 4 * LR_SIZE, 3)
    upscales_per_sec = batch * iters / dt

    # per-image latency of an image served in a batch of `batch`: dispatch to
    # device completion
    lat_iters = int(os.environ.get("BENCH_LAT_ITERS", "5"))
    lats = []
    for i in range(lat_iters):
        t0 = time.perf_counter()
        pipe.upscale_batch_device(imgs, gen(100 + i), as_uint8=True)
        _sync(device)
        lats.append(time.perf_counter() - t0)
    p50 = float(np.percentile(lats, 50))
    p99 = float(np.percentile(lats, 99))

    # the reference's own sampler, the T=100 ancestral chain, on the same weights
    full_chain = None
    if os.environ.get("BENCH_FULL_CHAIN", "1") not in ("0", "false") and not (sampler == "ddpm" and steps >= 100):
        hp_full = hp.replace(sampler="ddpm", sample_timesteps=0, timesteps=100)
        pipe_full = SRDiffPipeline(hp_full, params=pipe.model.state_dict(), device=device)
        pipe_full.upscale_batch_device(imgs, gen(0), as_uint8=True)
        _sync(device)  # warm-up and capture
        fc_iters = int(os.environ.get("BENCH_FULL_ITERS", "3"))
        t0 = time.perf_counter()
        fouts = [pipe_full.upscale_batch_device(imgs, gen(i), as_uint8=True) for i in range(fc_iters)]
        fouts = [o.cpu() for o in fouts]
        full_dt = time.perf_counter() - t0
        full_chain = batch * fc_iters / full_dt
        del pipe_full, fouts

    # batch-1 latency: one request of one image
    img1 = imgs[:1]
    pipe.upscale_batch_device(img1, gen(0), as_uint8=True)
    _sync(device)  # warm-up and capture at batch 1
    lats1 = []
    for i in range(lat_iters):
        t0 = time.perf_counter()
        pipe.upscale_batch_device(img1, gen(200 + i), as_uint8=True)
        _sync(device)
        lats1.append(time.perf_counter() - t0)
    p50_b1 = float(np.percentile(lats1, 50))
    p99_b1 = float(np.percentile(lats1, 99))

    result = {
        "metric": "srdiff_x4_512_upscales_per_sec_per_chip",
        "value": round(upscales_per_sec, 4),
        "unit": "images/sec",
        "vs_baseline": round(upscales_per_sec / BASELINE_UPSCALES_PER_SEC, 2),
        "p50_latency_s": round(p50, 4),
        "p99_latency_s": round(p99, 4),
        "value_from_p50": round(batch / p50, 4),  # the device's rate, without the copies to the host
        "latency_batch": batch,
        "p50_latency_s_b1": round(p50_b1, 4),
        "p99_latency_s_b1": round(p99_b1, 4),
        "sampler": sampler,
        "steps": steps,
        "eta": eta,
        "enc_interval": enc_interval,
        "full_chain_value": round(full_chain, 4) if full_chain else None,
        "full_chain_sampler": "ddpm100" if full_chain else None,
        "device": card_description(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
