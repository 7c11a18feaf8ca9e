"""Streamlit app: SRDiff x4 super-resolution on the GPU (counterpart of the
JAX package's ``apps/st_app_srdiff.py``; the reference's ``st_app1.py``).

Uploader, Enhance button, side-by-side render, PNG download, with the full
RRDB + UNet stack. The pure parts (loading the pipeline from
``SRDIFF_CONFIG`` / ``SRDIFF_CKPT``, the tiled-or-whole choice, the uint8
conversion) are functions of their own; ``streamlit`` is imported in
``main`` only.

Run: ``streamlit run dgm_img_super_resolution_tpu_torch/apps/st_app_srdiff.py``
"""

from __future__ import annotations

import io
import os
from typing import Callable, Mapping

import numpy as np

from dgm_img_super_resolution_tpu_torch.ops.image import unit_to_uint8

DEFAULT_CKPT = "srdiff/model_ckpt_steps_400000.ckpt"
WHOLE_MAX = 128  # LR images larger than this on a side are served in tiles of TILE
TILE = 64


def load_pipeline(env: Mapping[str, str] = os.environ, device: str | None = None):
    """The SRDiff pipeline of ``SRDIFF_CONFIG`` (a YAML config; bf16
    defaults without one) with the checkpoint at ``SRDIFF_CKPT`` when that
    file exists, else seeded random weights."""
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams, set_hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    config = env.get("SRDIFF_CONFIG", "")
    ckpt = env.get("SRDIFF_CKPT", DEFAULT_CKPT)
    hp = set_hparams(config) if config else Hparams(compute_dtype="bfloat16")
    return SRDiffPipeline(hp, ckpt_path=ckpt if os.path.exists(ckpt) else None, device=device)


def enhance(pipe, lr: np.ndarray, progress_cb: Callable[[int, int], None] | None = None) -> np.ndarray:
    """One HWC uint8 LR image -> the uint8 SR image: in tiles of ``TILE``
    when a side exceeds ``WHOLE_MAX``, else whole; progress every 10 steps."""
    if max(lr.shape[:2]) > WHOLE_MAX:
        sr = pipe.upscale_large(lr, patch=TILE, progress_cb=progress_cb, callback_steps=10)
    else:
        sr = pipe.upscale(lr, progress_cb=progress_cb, callback_steps=10)
    return unit_to_uint8(sr)


def main() -> None:
    import streamlit as st
    from PIL import Image

    st.title("SRDiff ×4 Super-Resolution (GPU)")
    st.caption("Conditional residual diffusion: the full RRDB + UNet on the GPU")
    pipe = st.cache_resource(load_pipeline)()
    uploaded = st.file_uploader("Upload a low-resolution image", type=["png", "jpg", "jpeg"])
    if uploaded is None:
        return
    image = Image.open(uploaded).convert("RGB")
    col1, col2 = st.columns(2)
    col1.image(image, caption=f"Input {image.size[0]}×{image.size[1]}")
    if st.button("Enhance Image"):
        with st.spinner("Sampling on the GPU…"):
            bar = st.progress(0.0)
            sr_u8 = enhance(pipe, np.asarray(image), lambda done, total: bar.progress(done / total))
            bar.empty()
        col2.image(sr_u8, caption=f"Enhanced {sr_u8.shape[1]}×{sr_u8.shape[0]}")
        buf = io.BytesIO()
        Image.fromarray(sr_u8).save(buf, format="PNG")
        st.download_button("Download enhanced image", data=buf.getvalue(), file_name="enhanced.png",
                           mime="image/png")


if __name__ == "__main__":
    main()
