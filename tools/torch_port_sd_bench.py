"""Time the full-size SD x4-upscaler pipeline of the PyTorch port on one
CUDA card (counterpart of ``tools/sd_bench.py``, which times the JAX
package's).

The reference app's operating point: a 128x128 LR image -> 512x512, 20
DDIM steps, guidance 9, prompt "a photo of a cat", bf16, published widths,
random weights (the published checkpoint is not in the repo; the compute is
the same). The first call eagerly runs the serve and captures its CUDA graph
(``compile_s``); the next ``SD_ITERS`` calls replay it with generators
seeded ``i + 1``, as ``sd_bench.py`` passes ``jax.random.PRNGKey(i + 1)``.

Knobs, as ``sd_bench.py``'s: ``SD_BATCH`` (1), ``SD_ENC`` (encoder
propagation interval, 1), ``SD_FLASH`` (the flash kernel on the UNet's
self-attention of at least 1024 tokens, on; ``0`` builds the UNet without
it), ``SD_STEPS`` (20), ``SD_ITERS`` (3), ``SD_OUT`` (also write the JSON
there); and the port's own ``SD_LR`` (128; 256 serves 1024x1024, where the
flash kernel runs). The LR image is ``np.random.default_rng(0)``'s.

Prints ``sd_bench.py``'s progress lines and ONE JSON line with its keys;
``backend`` is ``cuda`` or ``cpu``, and ``device`` the card's name and power
limit (``nvidia-smi``) or ``cpu``.

Usage, from anywhere in a checkout: ``python tools/torch_port_sd_bench.py
[--device D]``; the CUDA device by default, and with none and no
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgm_img_super_resolution_tpu_torch.core.device import card_description, resolve_device  # noqa: E402
from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline  # noqa: E402

PROMPT = "a photo of a cat"


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="", help="torch device; the CUDA device by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or None)
    batch = int(os.environ.get("SD_BATCH", "1"))
    enc = int(os.environ.get("SD_ENC", "1"))  # > 1: encoder propagation
    flash = os.environ.get("SD_FLASH", "1") not in ("0", "false", "")
    steps = int(os.environ.get("SD_STEPS", "20"))
    lr = int(os.environ.get("SD_LR", "128"))

    pipe = StableDiffusionUpscalePipeline(dtype=torch.bfloat16, use_flash=flash, device=device)
    img = np.random.default_rng(0).integers(0, 256, (batch, lr, lr, 3), dtype=np.uint8)

    t0 = time.perf_counter()
    out = pipe(PROMPT, img, num_inference_steps=steps, enc_interval=enc)
    compile_s = time.perf_counter() - t0
    print(f"first call (incl. capture): {compile_s:.1f}s out={out.shape} enc={enc} flash={flash}", flush=True)

    lats = []
    for i in range(int(os.environ.get("SD_ITERS", "3"))):
        t0 = time.perf_counter()
        out = pipe(PROMPT, img, num_inference_steps=steps, generator=torch.Generator(device=device).manual_seed(i + 1),
                   enc_interval=enc)
        dt = time.perf_counter() - t0
        lats.append(dt)
        print(f"steady-state: {dt:.2f}s / {batch} image(s) = {dt / batch:.2f}s per {4 * lr}² upscale", flush=True)

    p50 = float(np.percentile(lats, 50))
    result = {
        "metric": "sd_x4_512_upscale_p50_s",
        "value": round(p50 / batch, 3),
        "images_per_sec": round(batch / p50, 4),
        "batch": batch,
        "steps": steps,
        "enc_interval": enc,
        "use_flash": flash,
        "cfg": True,
        "compile_s": round(compile_s, 1),
        "baseline": "reference ~3600 s on CPU (st_app2.py:21)",
        "vs_baseline": round(3600.0 / (p50 / batch), 1),
        "backend": device.type,
        "device": card_description(device),
    }
    print(json.dumps(result), flush=True)
    if os.environ.get("SD_OUT"):
        with open(os.environ["SD_OUT"], "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
