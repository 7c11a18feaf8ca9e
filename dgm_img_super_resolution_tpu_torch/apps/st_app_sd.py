"""Streamlit app: the Stable Diffusion x4 upscaler on the GPU (counterpart of
the JAX package's ``apps/st_app_sd.py``; the reference's ``st_app2.py``).

Uploader, optional prompt, a per-step progress bar, the result beside the
input. The pure parts (loading the pipeline from ``SD_X4_CKPT_DIR``, the
input's 128x128 resize, the serve to uint8) are functions of their own;
``streamlit`` is imported in ``main`` only.

Run: ``streamlit run dgm_img_super_resolution_tpu_torch/apps/st_app_sd.py``
"""

from __future__ import annotations

import os
from typing import Callable, Mapping

import numpy as np

from dgm_img_super_resolution_tpu_torch.ops.image import unit_to_uint8

LOW_RES_SIZE = 128  # reference st_app2.py:34
NUM_STEPS = 20  # reference st_app2.py:53


def load_pipeline(env: Mapping[str, str] = os.environ, device: str | None = None, **pipeline_kwargs):
    """(pipeline, from_checkpoint): the diffusers checkout at
    ``SD_X4_CKPT_DIR`` when that directory exists, else random weights
    (demo mode). ``pipeline_kwargs`` go to either constructor."""
    ckpt_dir = env.get("SD_X4_CKPT_DIR", "")
    if ckpt_dir and os.path.isdir(ckpt_dir):
        from dgm_img_super_resolution_tpu_torch.ckpt.sd_import import load_sd_x4_pipeline

        return load_sd_x4_pipeline(ckpt_dir, device=device, **pipeline_kwargs), True
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    return StableDiffusionUpscalePipeline(device=device, **pipeline_kwargs), False


def prepare_input(image) -> np.ndarray:
    """A PIL image -> the app's HWC uint8 LR input at LOW_RES_SIZE square."""
    return np.asarray(image.convert("RGB").resize((LOW_RES_SIZE, LOW_RES_SIZE)))


def upscale(pipe, prompt: str, lr: np.ndarray, progress: Callable[[float], None] | None = None,
            num_steps: int = NUM_STEPS) -> np.ndarray:
    """One LR image and a prompt -> the uint8 x4 image; ``progress(f)``
    after every step with the fraction done."""
    cb = None if progress is None else (lambda step, t, latents: progress(min((step + 1) / num_steps, 1.0)))
    out = pipe(prompt or "", lr, num_inference_steps=num_steps, callback=cb, callback_steps=1)
    return unit_to_uint8(out[0])


def main() -> None:
    import streamlit as st
    from PIL import Image

    st.title("Stable Diffusion ×4 Upscaler (GPU)")
    pipe, from_ckpt = st.cache_resource(load_pipeline)()
    if not from_ckpt:
        st.warning("No SD_X4_CKPT_DIR set: running with random weights (demo mode).")
    uploaded = st.file_uploader("Upload an image", type=["png", "jpg", "jpeg"])
    prompt = st.text_input("Optional text prompt", value="")
    if uploaded is None:
        return
    lr = prepare_input(Image.open(uploaded))
    col1, col2 = st.columns(2)
    col1.image(lr, caption=f"Input {LOW_RES_SIZE}×{LOW_RES_SIZE}")
    if st.button("Upscale"):
        bar = st.progress(0)
        with st.spinner("Denoising on the GPU…"):
            sr = upscale(pipe, prompt, lr, bar.progress)
        col2.image(sr, caption=f"Upscaled {sr.shape[1]}×{sr.shape[0]}")


if __name__ == "__main__":
    main()
