"""End-to-end SR quality measurement (counterpart of the JAX package's
``metrics/measure.py``; the reference's ``Measure``, ``srdiff/model.py:1499-1542``).

``Measure.measure(img_a, img_b, img_lr, sr_scale)`` gives ``psnr``,
``ssim``, ``lpips`` and ``lr_psnr`` of HWC images, uint8 [0, 255] or float
[-1, 1]:

- ``psnr`` and ``ssim`` with scikit-image semantics on uint8 (data range
  255), on the measure's device;
- ``lr_psnr``: the SR image downscaled by MATLAB's bicubic
  (``ops.resize.imresize``, on the host) against the LR input;
- ``lpips``: the AlexNet LPIPS when weights are given, else ``nan``.

The device defaults to CUDA (``core/device.py``); pass ``device="cpu"`` to
measure on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.metrics.lpips import LPIPS
from dgm_img_super_resolution_tpu_torch.metrics.psnr_ssim import psnr, ssim_eval
from dgm_img_super_resolution_tpu_torch.ops.image import pm1_to_uint8
from dgm_img_super_resolution_tpu_torch.ops.resize import imresize


def _to_uint8_hwc(img) -> np.ndarray:
    img = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    return img if img.dtype == np.uint8 else pm1_to_uint8(img)


class Measure:
    def __init__(self, lpips_weights: str | None = None, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self._lpips = LPIPS.maybe_create(lpips_weights, self.device)

    def measure(self, img_a, img_b, img_lr, sr_scale: int) -> dict[str, float]:
        """img_a: SR output; img_b: HR ground truth; img_lr: LR input."""
        a = _to_uint8_hwc(img_a)
        b = _to_uint8_hwc(img_b)
        lr = _to_uint8_hwc(img_lr)
        return {
            "psnr": self.psnr(a, b),
            "ssim": self.ssim(a, b),
            "lpips": self.lpips(a, b),
            "lr_psnr": self.lr_psnr(a, lr, sr_scale),
        }

    def _on_device(self, img) -> torch.Tensor:
        return torch.from_numpy(np.array(img)).to(self.device, torch.float32)

    def psnr(self, img_a, img_b) -> float:
        return float(psnr(self._on_device(img_a), self._on_device(img_b), 255.0))

    def ssim(self, img_a, img_b) -> float:
        return ssim_eval(self._on_device(img_a), self._on_device(img_b), data_range=255.0)

    def lr_psnr(self, img_a, img_lr, sr_scale: int) -> float:
        down = imresize(np.asarray(img_a, np.uint8), scale=1.0 / sr_scale)
        return self.psnr(down, img_lr)

    def lpips(self, img_a, img_b) -> float:
        if self._lpips is None:
            return float("nan")
        return float(self._lpips(img_a, img_b))
