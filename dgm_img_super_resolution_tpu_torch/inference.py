"""End-to-end SRDiff serving pipeline (counterpart of the JAX package's
``inference.py:49-400``).

``SRDiffPipeline.upscale_batch_device`` does, in order: uint8 -> [-1, 1];
reflect-pad the LR batch to the UNet's 2^stages divisibility (edge padding
when the pad reaches the image's size); bicubic x4 (``torch`` variant); the
sampler (ancestral, or DDIM with eta); clip; crop back; optional uint8
rounding. It runs on ``cuda`` unless the caller passes another device, and
raises when no CUDA device is there and none was asked for.

Not ported yet: ``progress_cb``, ``upscale_large`` (tiled SR),
``interpolate``, encoder propagation (``enc_interval > 1``) and the
``max_native_hr_pixels`` sub-batching: a request over that budget raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.ops.image import uint8_to_pm1
from dgm_img_super_resolution_tpu_torch.ops.resize import resize


class SRDiffPipeline:
    def __init__(self, hp: Hparams | None = None, params: Mapping[str, torch.Tensor] | None = None,
                 device: str | torch.device | None = None, generator: torch.Generator | None = None):
        """``params``: a ``state_dict`` of the SRDiff stack under the
        reference checkpoint's names (``denoise_fn.*``, ``rrdb.*``), loaded
        strictly; ``None`` makes a random init seeded by ``hp['seed']``.
        ``generator`` draws the sampler noise; by default one on ``device``
        seeded by ``hp['seed']``."""
        self.hp = hp or Hparams()
        self.device = resolve_device(device)
        model = build_srdiff(self.hp)
        if params is None:
            init_srdiff_params(model, seed=int(self.hp["seed"]))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            # conv weights channels_last too, so that cuDNN sees NHWC on both sides
            self.model.to(memory_format=torch.channels_last)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(int(self.hp["seed"]))
        if int(self.hp.get("enc_interval", 1) or 1) > 1:
            raise NotImplementedError("encoder propagation (enc_interval > 1) is not ported yet")

    def _pad(self, h: int, w: int) -> tuple[int, int]:
        """LR pad that makes the HR grid divide by 2^(stages - 1)."""
        scale = self.hp["sr_scale"]
        div = 2 ** (len(self.hp.unet_dim_mults_tuple) - 1)
        ph = next(p for p in range(div + 1) if (h + p) * scale % div == 0)
        pw = next(p for p in range(div + 1) if (w + p) * scale % div == 0)
        return ph, pw

    @torch.inference_mode()
    def upscale_batch_device(self, imgs, generator: torch.Generator | None = None,
                             as_uint8: bool = False, noise=None) -> torch.Tensor:
        """imgs: NHWC uint8 [0, 255] or float [-1, 1] LR batch (numpy or
        torch) -> NHWC float [0, 1] (or uint8 with ``as_uint8``) SR batch at
        x scale, left on the device. ``noise`` is the samplers' noise hook
        (see ``diffusion/gaussian.py``), in the padded NCHW shape."""
        x = imgs if isinstance(imgs, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(imgs))
        n, h, w = (int(v) for v in x.shape[:3])
        ph, pw = self._pad(h, w)
        scale = self.hp["sr_scale"]
        budget = int(self.hp.get("max_native_hr_pixels", 0) or 0)
        hr_pixels = n * (h + ph) * (w + pw) * scale * scale
        if budget and hr_pixels > budget:
            raise ValueError(
                f"request of {hr_pixels} HR pixels exceeds max_native_hr_pixels={budget}; "
                "tiled upscale_large and sub-batching are not ported yet"
            )
        x = x.to(self.device)
        x = uint8_to_pm1(x) if x.dtype == torch.uint8 else x.to(torch.float32)
        x = x.permute(0, 3, 1, 2)
        if ph or pw:
            mode = "reflect" if ph < h and pw < w else "replicate"
            x = F.pad(x, (0, pw, 0, ph), mode=mode)
        img_lr_up = resize(x, ((h + ph) * scale, (w + pw) * scale), variant="torch")
        gen = generator or self.generator
        if self.hp.get("sampler", "ddpm") == "ddim":
            img, _ = self.model.ddim_sample(
                x, img_lr_up, num_steps=self.hp.get("sample_timesteps", 0) or None,
                eta=float(self.hp.get("ddim_eta", 0.0)), noise=noise, generator=gen,
            )
        else:
            img, _ = self.model.sample(x, img_lr_up, noise=noise, generator=gen)
        out = (img * 0.5 + 0.5).clamp(0.0, 1.0)[:, :, : h * scale, : w * scale]
        out = out.permute(0, 2, 3, 1)
        if as_uint8:
            out = torch.round(out * 255.0).to(torch.uint8)
        return out

    def upscale_batch(self, imgs, generator: torch.Generator | None = None, noise=None) -> np.ndarray:
        """NHWC LR batch -> NHWC float [0, 1] SR batch on the host."""
        return self.upscale_batch_device(imgs, generator, noise=noise).cpu().numpy()

    def upscale(self, image, generator: torch.Generator | None = None, noise=None) -> np.ndarray:
        """One HWC image -> HWC float [0, 1] SR image."""
        return self.upscale_batch(np.asarray(image)[None], generator, noise=noise)[0]
