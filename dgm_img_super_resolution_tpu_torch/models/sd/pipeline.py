"""Stable Diffusion x4-upscaler serving pipeline (counterpart of the JAX
package's ``models/sd/pipeline.py``).

CLIP text encode (cond and uncond) -> noise-augment the LR image on the
low-res DDPM schedule -> denoising loop over latents with the LR image
concatenated on channels -> VAE decode to x4 resolution, NHWC float [0, 1].

The loop runs on the host in Python, one UNet call per step: classifier-free
guidance is a doubled batch through that call; the model predicts v; the
timesteps are diffusers' "leading" spacing with ``steps_offset`` and
``set_alpha_to_one`` from the scheduler config; the update is DDIM with eta
(``sampler="ddpm"`` is the respaced ancestral chain, which is DDIM with eta
1). Noise comes from an explicit ``torch.Generator`` or from a noise hook
``noise=(latents, aug_noise, {t: eps_t})`` of NCHW float32 tensors, so that
a test can feed the JAX draws. It runs on ``cuda`` unless the caller passes
a device, and raises when there is no CUDA device and none was asked for.

Weights: a ``{"unet", "vae", "text_encoder"}`` dict of state dicts under the
published names, loaded strictly, or a random init from ``seed``. The
schedules are the published scheduler configs (``ckpt/sd_inventory.py``).
Not ported yet: encoder propagation (``enc_interval > 1``), negative
prompts, a checkpoint's own scheduler configs.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import (
    X4_LOW_RES_SCHEDULER_CONFIG,
    X4_SCHEDULER_CONFIG,
    X4_TEXT_CONFIG,
    X4_UNET_CONFIG,
    X4_VAE_CONFIG,
)
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.diffusion.schedule import Schedule, make_schedule
from dgm_img_super_resolution_tpu_torch.models.sd.clip import CLIPTextEncoder, SimpleTokenizer
from dgm_img_super_resolution_tpu_torch.models.sd.unet import UNet2DCondition
from dgm_img_super_resolution_tpu_torch.models.sd.vae import AutoencoderKL


def _schedule_from_config(cfg: dict) -> Schedule:
    """A diffusers ``scheduler_config.json`` -> the precomputed buffers;
    diffusers' ``scaled_linear`` is the ``quad`` schedule (linear in sqrt beta)."""
    name = {"scaled_linear": "quad", "squaredcos_cap_v2": "cosine"}.get(
        cfg.get("beta_schedule", "scaled_linear"), cfg.get("beta_schedule"))
    return make_schedule(timesteps=int(cfg.get("num_train_timesteps", 1000)), beta_schedule=name,
                         beta_start=float(cfg.get("beta_start", 0.0001)),
                         beta_end=float(cfg.get("beta_end", 0.02)), res=False)


@torch.no_grad()
def init_sd_params(module: nn.Module, seed: int) -> None:
    """Seeded random weights in place, on the module's device: norm scales
    1 + N(0, 0.05), biases N(0, 0.02), embedding tables N(0, 0.05), conv and
    linear kernels N(0, 1/fan_in)."""
    gen = None
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            z = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            if name == "bias":
                z *= 0.02
            elif p.dim() == 1:
                z = 1.0 + 0.05 * z
            elif isinstance(m, nn.Embedding):
                z *= 0.05
            else:
                z /= math.sqrt(p[0].numel())
            p.copy_(z)


class StableDiffusionUpscalePipeline:
    def __init__(self, params: Mapping[str, Mapping[str, torch.Tensor]] | None = None, *,
                 unet_config: dict = X4_UNET_CONFIG, vae_config: dict = X4_VAE_CONFIG,
                 text_config: dict = X4_TEXT_CONFIG, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None, seed: int = 0):
        """``params``: ``{"unet": ..., "vae": ..., "text_encoder": ...}``
        state dicts (float32) under the published names; ``None`` draws
        random weights from ``seed``. The configs default to the published
        ones; the noise comes from a generator on ``device`` seeded by
        ``seed`` unless a call brings its own."""
        self.device = resolve_device(device)
        self.dtype = dtype
        with torch.device(self.device):
            self.unet = UNet2DCondition(unet_config)
            self.vae = AutoencoderKL(vae_config)
            self.text_encoder = CLIPTextEncoder(text_config)
        modules = {"unet": self.unet, "vae": self.vae, "text_encoder": self.text_encoder}
        for i, (name, m) in enumerate(modules.items()):
            if params is None:
                init_sd_params(m, seed + i)
            else:
                m.load_state_dict(params[name], strict=True)
            m.to(self.dtype).eval().requires_grad_(False)
        # the hash-bucket fallback until the published BPE vocab is in the repo
        self.tokenizer = SimpleTokenizer(vocab_size=text_config["vocab_size"],
                                         max_len=text_config["max_position_embeddings"])
        sc = X4_SCHEDULER_CONFIG
        if sc["prediction_type"] != "v_prediction":
            raise NotImplementedError(f"prediction_type {sc['prediction_type']!r}")
        self.schedule = _schedule_from_config(sc)  # denoising: v-prediction latent betas
        self.steps_offset = int(sc["steps_offset"])
        acp0 = self.schedule.alphas_cumprod[0]
        self.final_alpha_cumprod = np.float32(1.0) if sc["set_alpha_to_one"] else acp0
        self.low_res_schedule = _schedule_from_config(X4_LOW_RES_SCHEDULER_CONFIG)  # LR noise augmentation
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- internals
    def encode_prompt(self, prompts: list[str]):
        """(cond, uncond) text states, each (N, 77, width) in the pipeline's
        dtype; uncond encodes the empty prompt."""
        ids = self.tokenizer(list(prompts) + [""] * len(prompts))
        states = self.text_encoder(torch.from_numpy(ids.astype(np.int64)).to(self.device))
        return states[: len(prompts)], states[len(prompts):]

    def _prepare(self, image: torch.Tensor, noise_level: int, noise, gen):
        """Noise-augment the LR image on the low-res schedule; the initial
        latents. ``image``: (N, 3, h, w) float32 in [-1, 1]."""
        s = self.low_res_schedule
        n, _, h, w = image.shape
        if noise is None:
            x = torch.randn((n, self.vae.latent_channels, h, w), generator=gen, device=self.device)
            aug = torch.randn(image.shape, generator=gen, device=self.device)
        else:
            x, aug = (t.to(self.device, torch.float32) for t in noise[:2])
        img_aug = float(s.sqrt_alphas_cumprod[noise_level]) * image \
            + float(s.sqrt_one_minus_alphas_cumprod[noise_level]) * aug
        return x, img_aug.to(self.dtype)

    def _model_out(self, x, t: int, img_aug, ctx, nl, guidance_scale: float):
        """The UNet's prediction at ``t`` in float32, guided: with CFG one call
        on the doubled batch, cond first."""
        inp = torch.cat([x.to(self.dtype), img_aug], dim=1)
        if guidance_scale == 1.0:
            tt = torch.full((x.shape[0],), t, dtype=torch.long, device=self.device)
            return self.unet(inp, tt, ctx, nl).float()
        tt = torch.full((2 * x.shape[0],), t, dtype=torch.long, device=self.device)
        out_c, out_u = self.unet(torch.cat([inp, inp]), tt, ctx, nl).float().chunk(2)
        return out_u + guidance_scale * (out_c - out_u)

    def _update(self, x, t: int, t_prev: int, model_out, eta: float, z):
        """One DDIM step x_t -> x_prev from the predicted v (no x0
        clipping: ``clip_sample`` is off in the published config); ``z`` is
        the step noise when ``eta`` > 0. The coefficients are float32
        scalars, as on the JAX side."""
        acp = self.schedule.alphas_cumprod
        a_t = acp[t]
        a_prev = acp[t_prev] if t_prev >= 0 else self.final_alpha_cumprod
        one = np.float32(1.0)
        sq_a, sq_1ma = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        x0 = sq_a * x - sq_1ma * model_out  # v-prediction
        eps = sq_a * model_out + sq_1ma * x
        sigma = np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t)) * np.sqrt(one - a_t / a_prev)
        out = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(max(one - a_prev - sigma * sigma, 0))) * eps
        return out + float(sigma) * z if eta else out

    def _decode(self, x) -> torch.Tensor:
        return self.vae.decode(x.to(self.dtype)).float().clamp(-1.0, 1.0)

    # ------------------------------------------------------------------- API
    @torch.inference_mode()
    def upscale_device(self, prompt: str | list[str], image, num_inference_steps: int = 20,
                       guidance_scale: float = 9.0, noise_level: int = 20,
                       generator: torch.Generator | None = None, callback: Callable | None = None,
                       callback_steps: int = 1, eta: float = 0.0, sampler: str = "ddim",
                       noise=None) -> torch.Tensor:
        """LR image(s), HWC or NHWC, uint8 or float in [-1, 1] (numpy or
        torch) -> x4 images, NHWC float [0, 1], left on the device.
        ``callback(i, t, latents)`` fires after every ``callback_steps``-th
        step and after the last (latents NCHW float32). ``sampler`` is
        ``"ddim"`` with ``eta`` (0 = deterministic) or ``"ddpm"`` (eta 1)."""
        if sampler == "ddpm":
            eta = 1.0
        elif sampler != "ddim":
            raise ValueError(f"unknown sampler {sampler!r}")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
        img = img.to(self.device)
        if img.dim() == 3:
            img = img[None]
        img = img.float() / 127.5 - 1.0 if img.dtype == torch.uint8 else img.float()
        img = img.permute(0, 3, 1, 2)
        n = img.shape[0]
        if len(prompts) == 1 and n > 1:
            prompts = prompts * n
        cond, uncond = self.encode_prompt(prompts)

        # diffusers "leading" spacing: for T=1000 and 20 steps 951, 901, ..., 1
        T, steps = self.schedule.num_timesteps, int(num_inference_steps)
        ratio = T // steps
        if ratio < 1:
            raise ValueError(f"num_inference_steps {steps} > trained T {T}")
        ts = (np.arange(steps) * ratio)[::-1] + self.steps_offset
        gen = generator or self.generator
        x, img_aug = self._prepare(img, int(noise_level), noise, gen)
        gs = float(guidance_scale)
        ctx = cond if gs == 1.0 else torch.cat([cond, uncond])
        nl = torch.full((ctx.shape[0],), int(noise_level), dtype=torch.long, device=self.device)
        every = max(1, int(callback_steps))
        for i, t in enumerate(int(t) for t in ts):
            out = self._model_out(x, t, img_aug, ctx, nl, gs)
            z = None
            if eta:
                z = torch.randn(x.shape, generator=gen, device=self.device) if noise is None \
                    else noise[2][t].to(self.device, torch.float32)
            x = self._update(x, t, t - ratio, out, float(eta), z)
            if callback is not None and ((i + 1) % every == 0 or i == steps - 1):
                callback(i, t, x)
        return (self._decode(x) * 0.5 + 0.5).permute(0, 2, 3, 1)

    def __call__(self, prompt, image, **kwargs) -> np.ndarray:
        """As :meth:`upscale_device`, returned on the host as numpy."""
        return self.upscale_device(prompt, image, **kwargs).cpu().numpy()
