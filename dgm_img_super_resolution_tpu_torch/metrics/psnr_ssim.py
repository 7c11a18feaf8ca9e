"""PSNR and SSIM on a tensor's device (counterpart of the JAX package's
``metrics/psnr_ssim.py``).

Two SSIMs, as in the reference:

- :func:`ssim` / :class:`SSIM`: the training-loss SSIM over NCHW batches
  (11x11 gaussian window, sigma 1.5, depthwise ``F.conv2d`` with zero
  padding, inputs remapped [-1, 1] -> [0, 1], biased covariance);
  differentiable by plain autograd.
- :func:`ssim_eval`: the evaluation SSIM with scikit-image semantics on HWC
  or HW images (uniform 7x7 window, sample covariance N/(N-1), the valid
  map, then the mean over it and the channels), which the reference's
  ``Measure`` computes through ``skimage.metrics.structural_similarity``.

Everything runs in float32 on the device of the tensors given; numpy
arrays are taken on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.ops import rowsplit


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def psnr(a, b, data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio, the MSE over all elements (as skimage),
    in float32 on ``a``'s device."""
    a = _tensor(a).to(torch.float32)
    b = _tensor(b).to(a.device, torch.float32)
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / mse)


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


_WINDOWS: dict[tuple, torch.Tensor] = {}


def _window_on(window_size: int, device: torch.device) -> torch.Tensor:
    """The loss SSIM's gaussian window on ``device``, copied there once (a
    captured training step reads it at its address; a copy from the host
    cannot be captured)."""
    key = (window_size, str(device))
    if key not in _WINDOWS:
        _WINDOWS[key] = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(device)
    return _WINDOWS[key]


def _depthwise(x: torch.Tensor, win: torch.Tensor, padding: int) -> torch.Tensor:
    """NCHW depthwise conv with the same window on every channel; under a
    row split (``ops/rowsplit.py``) over this member's rows, with its
    neighbours' ``padding`` rows and zeros at the image's outer rows."""
    c = x.shape[1]
    w = win.to(x.device)[None, None].expand(c, 1, *win.shape)
    if rowsplit.active() is not None:
        if not padding:
            raise NotImplementedError("a valid window under a row split")
        return F.conv2d(rowsplit.halo(x, padding), w, padding=(0, padding), groups=c)
    return F.conv2d(x, w, padding=padding, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11, size_average: bool = True,
         remap_pm1: bool = True) -> torch.Tensor:
    """Gaussian-window SSIM over NCHW batches (the training-loss variant).
    ``remap_pm1`` maps [-1, 1] to [0, 1] first; C1 and C2 assume [0, 1].
    A scalar, or one value per image without ``size_average``."""
    if remap_pm1:
        img1 = img1 * 0.5 + 0.5
        img2 = img2 * 0.5 + 0.5
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    win = _window_on(window_size, img1.device)
    pad = window_size // 2
    mu1 = _depthwise(img1, win, pad)
    mu2 = _depthwise(img2, win, pad)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise(img1 * img1, win, pad) - mu1_sq
    sigma2_sq = _depthwise(img2 * img2, win, pad) - mu2_sq
    sigma12 = _depthwise(img1 * img2, win, pad) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


class SSIM(nn.Module):
    """The reference ``SSIM`` module's surface over :func:`ssim`."""

    def __init__(self, window_size: int = 11, size_average: bool = True):
        super().__init__()
        self.window_size = window_size
        self.size_average = size_average

    def forward(self, img1, img2):
        return ssim(img1, img2, self.window_size, self.size_average)


def ssim_eval(a, b, data_range: float = 255.0, win_size: int = 7) -> float:
    """scikit-image ``structural_similarity`` on HWC or HW images: uniform
    window, sample covariance, the valid map's mean over pixels and
    channels. Runs on ``a``'s device (the CPU for numpy)."""
    x = _tensor(a).to(torch.float32)
    y = _tensor(b).to(x.device, torch.float32)
    if x.dim() == 2:
        x, y = x[..., None], y[..., None]
    x = x.permute(2, 0, 1)[None]
    y = y.permute(2, 0, 1)[None]
    win = torch.full((win_size, win_size), 1.0 / (win_size * win_size), dtype=torch.float32)
    ux = _depthwise(x, win, 0)
    uy = _depthwise(y, win, 0)
    uxx = _depthwise(x * x, win, 0)
    uyy = _depthwise(y * y, win, 0)
    uxy = _depthwise(x * y, win, 0)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return float(s.mean())
