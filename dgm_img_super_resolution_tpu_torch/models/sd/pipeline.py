"""Stable Diffusion x4-upscaler serving pipeline (counterpart of the JAX
package's ``models/sd/pipeline.py``).

CLIP text encode (cond and uncond) -> noise-augment the LR image on the
low-res DDPM schedule -> denoising loop over latents with the LR image
concatenated on channels -> VAE decode to x4 resolution, NHWC float [0, 1].

The serve is one program (``_pieces``: the CLIP encode of the token ids
and ``_prepare``, the loop, the VAE decode), captured on the card as one
CUDA graph per call shape (``core/graphs.py``; JAX jits ``_encode_tokens``,
``_prepare``, ``_denoise_segment`` and the decode): the key is the batch,
the LR size, the steps, guidance, noise level, eta, ``enc_interval`` and
the noise's shapes; the token ids, of the prompts and the negative prompts
alike, are a static input. With a callback the loop is cut where the
callback fires, and the serve is one segmented program (a graph a piece,
the callback on the host between them), keyed as without one plus
``callback_steps``, in the same cache and pool. A noise hook that is not
tensors, ``graphs.eager()`` and the CPU run the same pieces eagerly.
The loop makes one UNet call per step: classifier-free
guidance is a doubled batch through that call, its unconditional half
encoding the negative prompt (empty by default); the published model
predicts v (``prediction_type`` "epsilon" is taken too); the timesteps are
diffusers' "leading" spacing with ``steps_offset`` and ``set_alpha_to_one``
from the scheduler config; the update is DDIM with eta (``sampler="ddpm"``
is the respaced ancestral chain, which is DDIM with eta 1). With
``enc_interval`` K > 1 and no callback, the UNet's down path runs at the
first step of each group of K and its features serve the group's K decodes
(encoder propagation); the steps K does not divide run exactly at the end.
Noise comes from an explicit ``torch.Generator`` or from a noise hook
``noise=(latents, aug_noise, {t: eps_t})`` of NCHW float32 tensors, so that
a test can feed the JAX draws. It runs on ``cuda`` unless the caller passes
a device, and raises when there is no CUDA device and none was asked for.

Weights: a ``{"unet", "vae", "text_encoder"}`` dict of state dicts under the
published names, loaded strictly, or a random init from ``seed``. The
schedules are the published scheduler configs (``ckpt/sd_inventory.py``),
each key of which ``scheduler_config`` / ``low_res_scheduler_config``
overrides.
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
from dgm_img_super_resolution_tpu_torch.core import graphs
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
                 device: str | torch.device | None = None, seed: int = 0,
                 scheduler_config: dict | None = None, low_res_scheduler_config: dict | None = None,
                 tokenizer: SimpleTokenizer | None = None, use_flash: bool = True):
        """``params``: ``{"unet": ..., "vae": ..., "text_encoder": ...}``
        state dicts (float32) under the published names; ``None`` draws
        random weights from ``seed``. The configs default to the published
        ones; ``scheduler_config`` and ``low_res_scheduler_config`` override
        keys of the published scheduler configs. ``tokenizer`` defaults to
        the hash-bucket ``SimpleTokenizer`` (no vocabulary files); pass one
        built from the published BPE files for the exact tokens. The noise
        comes from a generator on ``device`` seeded by ``seed`` unless a
        call brings its own. ``use_flash`` builds the UNet with or without
        the flash kernel on its long self-attentions (``UNet2DCondition``;
        JAX's pipeline takes a UNet built so). It is fixed for the
        pipeline's life, and so is the routing every captured serve of
        ``self._graphs`` recorded: no graph serves the other routing."""
        self.device = resolve_device(device)
        self.dtype = dtype
        with torch.device(self.device):
            self.unet = UNet2DCondition(unet_config, use_flash=use_flash)
            self.vae = AutoencoderKL(vae_config)
            self.text_encoder = CLIPTextEncoder(text_config)
        modules = {"unet": self.unet, "vae": self.vae, "text_encoder": self.text_encoder}
        for i, (name, m) in enumerate(modules.items()):
            if params is None:
                init_sd_params(m, seed + i)
            else:
                m.load_state_dict(params[name], strict=True)
            m.to(self.dtype).eval().requires_grad_(False)
        self.tokenizer = tokenizer if tokenizer is not None else SimpleTokenizer(
            vocab_size=text_config["vocab_size"], max_len=text_config["max_position_embeddings"])
        sc = dict(X4_SCHEDULER_CONFIG, **(scheduler_config or {}))
        lrc = dict(X4_LOW_RES_SCHEDULER_CONFIG, **(low_res_scheduler_config or {}))
        self.schedule = _schedule_from_config(sc)  # denoising: the latent betas
        self.prediction_type = sc.get("prediction_type", "epsilon")
        self.steps_offset = int(sc.get("steps_offset", 0))
        acp0 = self.schedule.alphas_cumprod[0]
        self.final_alpha_cumprod = np.float32(1.0) if sc.get("set_alpha_to_one", True) else acp0
        self.low_res_schedule = _schedule_from_config(lrc)  # LR noise augmentation
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._graphs = graphs.GraphCache()  # the captured serves, by call shape

    # ------------------------------------------------------------- internals
    def encode_prompt(self, prompts: list[str], negative: list[str] | None = None):
        """(cond, uncond) text states, each (N, 77, width) in the pipeline's
        dtype; uncond encodes the negative prompts, empty by default."""
        negative = self._negatives(prompts, negative)
        states = self.text_encoder(self._token_ids(prompts, negative))
        return states[: len(prompts)], states[len(prompts):]

    def _token_ids(self, prompts: list[str], negative: list[str]) -> torch.Tensor:
        """The prompts' then the negative prompts' token ids, (2N, 77) int64
        on the device."""
        ids = self.tokenizer(list(prompts) + list(negative))
        return torch.from_numpy(ids.astype(np.int64)).to(self.device)

    @staticmethod
    def _negatives(prompts: list[str], negative: list[str] | None) -> list[str]:
        negative = [""] * len(prompts) if negative is None else list(negative)
        if len(negative) != len(prompts):
            raise ValueError(f"{len(negative)} negative prompts for {len(prompts)} prompts")
        return negative

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

    def _model_out(self, x, t: int, img_aug, ctx, nl, guidance_scale: float, mode: str = "full", enc=None):
        """The UNet at ``t``, with CFG one call on the doubled batch (cond
        first): the guided prediction in float32, or with ``mode="encode"``
        the down path's features, which ``mode="decode"`` takes as ``enc``
        (``x`` unused)."""
        cfg = guidance_scale != 1.0
        tt = torch.full((ctx.shape[0],), t, dtype=torch.long, device=self.device)
        if mode == "decode":
            out = self.unet(None, tt, ctx, nl, mode="decode", enc_feats=enc)
        else:
            inp = torch.cat([x.to(self.dtype), img_aug], dim=1)
            out = self.unet(torch.cat([inp, inp]) if cfg else inp, tt, ctx, nl, mode=mode)
            if mode == "encode":
                return out
        out = out.float()
        if not cfg:
            return out
        out_c, out_u = out.chunk(2)
        return out_u + guidance_scale * (out_c - out_u)

    def _update(self, x, t: int, t_prev: int, model_out, eta: float, z):
        """One DDIM step x_t -> x_prev from the model's prediction of v (or
        eps, by ``prediction_type``), with no x0 clipping (``clip_sample``
        is off in the published config); ``z`` is the step noise when
        ``eta`` > 0. The coefficients are float32 scalars, as on the JAX
        side."""
        acp = self.schedule.alphas_cumprod
        a_t = acp[t]
        a_prev = acp[t_prev] if t_prev >= 0 else self.final_alpha_cumprod
        one = np.float32(1.0)
        sq_a, sq_1ma = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        if self.prediction_type == "v_prediction":
            x0 = sq_a * x - sq_1ma * model_out
            eps = sq_a * model_out + sq_1ma * x
        elif self.prediction_type == "epsilon":
            eps = model_out
            x0 = (x - sq_1ma * eps) / sq_a
        else:
            raise NotImplementedError(self.prediction_type)
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
                       noise=None, negative_prompt: str | list[str] | None = None,
                       enc_interval: int = 1) -> torch.Tensor:
        """LR image(s), HWC or NHWC, uint8 or float in [-1, 1] (numpy or
        torch) -> x4 images, NHWC float [0, 1], left on the device.
        ``callback(i, t, latents)`` fires after every ``callback_steps``-th
        step and after the last (latents NCHW float32); the callback's path
        runs every step exactly. ``sampler`` is ``"ddim"`` with ``eta`` (0 =
        deterministic) or ``"ddpm"`` (eta 1). ``negative_prompt``: one
        string for every image, or one per image. ``enc_interval`` > 1:
        encoder propagation."""
        if sampler == "ddpm":
            eta = 1.0
        elif sampler != "ddim":
            raise ValueError(f"unknown sampler {sampler!r}")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
        img = img.to(self.device)
        if img.dim() == 3:
            img = img[None]
        n = img.shape[0]
        if len(prompts) == 1 and n > 1:
            prompts = prompts * n
        negatives = [negative_prompt] * n if isinstance(negative_prompt, str) else negative_prompt
        ids = self._token_ids(prompts, self._negatives(prompts, negatives))
        gen = generator or self.generator
        args = (int(num_inference_steps), float(guidance_scale), int(noise_level), float(eta),
                max(1, int(enc_interval)) if callback is None else 1)
        noise_in = {} if noise is None else graphs.tensor_inputs("noise", noise)

        def noise_of(inputs):
            return noise if noise is None or noise_in is None else graphs.rebuild("noise", noise, inputs)

        fns, after = self._pieces(args, noise_of, callback, callback_steps)
        inputs = {"ids": ids, "image": img, **(noise_in or {})}
        if noise_in is None or not graphs.enabled(self.device):
            return graphs.run_pieces(fns, inputs, gen, after)
        key = ("sd", tuple(img.shape), img.dtype, tuple(ids.shape), graphs.signature(noise), args)
        if callback is None:
            return self._graphs.run(key, lambda inputs, g: graphs.run_pieces(fns, inputs, g, after), inputs, gen)
        return self._graphs.run_program(key + (max(1, int(callback_steps)),), fns, inputs, gen, after)

    def _pieces(self, args, noise_of: Callable, callback: Callable | None = None,
                callback_steps: int = 1) -> tuple[list, list]:
        """The serve from the token ids and the NHWC LR batch on the device
        to the x4 batch, as the pieces of ``graphs.run_pieces`` /
        ``GraphCache.run_program``: the CLIP encode and ``_prepare``, the
        denoise loop in segments that end where the callback fires (one
        segment without a callback), the VAE decode; ``callback(i, t,
        latents)`` after each segment, the latents a clone. ``args``:
        (steps, guidance, noise level, eta, enc_interval); ``noise_of(inputs)``
        the noise (None, or the hook of tensors on the inputs)."""
        steps, gs, noise_level, eta, K = args
        # diffusers "leading" spacing: for T=1000 and 20 steps 951, 901, ..., 1
        T = self.schedule.num_timesteps
        ratio = T // steps
        if ratio < 1:
            raise ValueError(f"num_inference_steps {steps} > trained T {T}")
        ts = [int(t) for t in (np.arange(steps) * ratio)[::-1] + self.steps_offset]
        every = max(1, int(callback_steps))
        stops = [i + 1 for i in range(steps) if (i + 1) % every == 0 or i == steps - 1] \
            if callback is not None else [steps]

        def prep(inputs, _, gen):
            img = inputs["image"]
            img = img.float() / 127.5 - 1.0 if img.dtype == torch.uint8 else img.float()
            img = img.permute(0, 3, 1, 2)
            n = img.shape[0]
            states = self.text_encoder(inputs["ids"])
            cond, uncond = states[:n], states[n:]
            x, img_aug = self._prepare(img, noise_level, noise_of(inputs), gen)
            ctx = cond if gs == 1.0 else torch.cat([cond, uncond])
            nl = torch.full((ctx.shape[0],), noise_level, dtype=torch.long, device=self.device)
            return x, img_aug, ctx, nl

        def segment(a: int, b: int) -> Callable:
            def fn(inputs, st, gen):
                x, img_aug, ctx, nl = st
                noise = noise_of(inputs)
                enc = None
                for i in range(a, b):
                    t = ts[i]
                    if i < steps // K * K and K > 1:
                        if i % K == 0:
                            enc = self._model_out(x, t, img_aug, ctx, nl, gs, mode="encode")
                        out = self._model_out(None, t, None, ctx, nl, gs, mode="decode", enc=enc)
                    else:
                        out = self._model_out(x, t, img_aug, ctx, nl, gs)
                    z = None
                    if eta:
                        z = torch.randn(x.shape, generator=gen, device=self.device) if noise is None \
                            else noise[2][t].to(self.device, torch.float32)
                    x = self._update(x, t, t - ratio, out, eta, z)
                return x, img_aug, ctx, nl
            return fn

        def finish(inputs, st, gen):
            return (self._decode(st[0]) * 0.5 + 0.5).permute(0, 2, 3, 1)

        fns = [prep] + [segment(a, b) for a, b in zip([0] + stops, stops)] + [finish]
        after = [None] * len(fns)
        if callback is not None:
            for k, b in enumerate(stops):
                after[k + 1] = lambda st, i=b - 1: callback(i, ts[i], st[0].clone())
        return fns, after

    def __call__(self, prompt, image, **kwargs) -> np.ndarray:
        """As :meth:`upscale_device`, returned on the host as numpy."""
        return self.upscale_device(prompt, image, **kwargs).cpu().numpy()
