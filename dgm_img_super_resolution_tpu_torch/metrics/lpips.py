"""LPIPS perceptual metric with the AlexNet backbone (counterpart of the JAX
package's ``metrics/lpips.py``).

The reference scores LPIPS through the ``lpips`` package. Its pretrained
AlexNet and linear heads are not in the repository, so the scorer is
weight-gated: :meth:`LPIPS.maybe_create` returns ``None`` without a weights
file. It reads the JAX package's ``.npz`` (its Flax param tree, '/'-joined
keys) or a torch ``lpips.LPIPS(net='alex')`` state dict
(``ckpt/torch_import.py:import_lpips``). The port's parameter names are the
Flax module names: ``alex.conv1.weight`` ... ``alex.conv5.bias`` and
``lin0.weight`` ... ``lin4.weight``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _AlexFeatures(nn.Module):
    """AlexNet feature trunk, returning the five ReLU taps LPIPS uses."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x):
        taps = []
        x = F.relu(self.conv1(x))
        taps.append(x)
        x = F.relu(self.conv2(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv3(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv4(x))
        taps.append(x)
        x = F.relu(self.conv5(x))
        taps.append(x)
        return taps


class _LPIPSNet(nn.Module):
    """Unit-normalised feature differences weighted per channel; one
    distance per image of an NCHW [-1, 1] pair."""

    lin_dims = (64, 192, 384, 256, 256)

    def __init__(self):
        super().__init__()
        self.alex = _AlexFeatures()
        for i, c in enumerate(self.lin_dims):
            setattr(self, f"lin{i}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, a, b):
        fa = self.alex((a - self.shift) / self.scale)
        fb = self.alex((b - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            # lpips.normalize_tensor: eps outside the sqrt
            na = xa / (torch.sqrt(torch.sum(xa ** 2, dim=1, keepdim=True)) + 1e-10)
            nb = xb / (torch.sqrt(torch.sum(xb ** 2, dim=1, keepdim=True)) + 1e-10)
            total = total + getattr(self, f"lin{i}")((na - nb) ** 2).mean(dim=(1, 2, 3))
        return total


class LPIPS:
    """Weight-gated LPIPS scorer over uint8 HWC or [-1, 1] float images. On
    the card the network is one captured graph per pair of image shapes
    (JAX's ``jax.jit``, ``metrics/lpips.py:82``) and the network's tensors'
    addresses, captured at a key's second call (``on_repeat``: images of a
    size scored once pay no capture) and replayed from the third; eager on
    the CPU and under ``graphs.eager()``."""

    def __init__(self, state_dict: dict, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.net = _LPIPSNet()
        self.net.load_state_dict(state_dict, strict=True)
        self.net.to(self.device).eval().requires_grad_(False)
        self._graphs = graphs.GraphCache()

    @classmethod
    def maybe_create(cls, weights_path: str | None, device: str | torch.device | None = None) -> "LPIPS | None":
        """``None`` without a weights file; a ``.npz`` holds the JAX param
        tree, any other file a torch ``lpips`` state dict."""
        if not weights_path or not os.path.exists(weights_path):
            return None
        if weights_path.endswith(".npz"):
            from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_npz_to_state_dict

            return cls(jax_npz_to_state_dict(weights_path), device)
        from dgm_img_super_resolution_tpu_torch.ckpt.torch_import import import_lpips

        return import_lpips(weights_path, device)

    def _prep(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        x = x.to(torch.float32) / 127.5 - 1.0 if x.dtype == torch.uint8 else x.to(torch.float32)
        if x.dim() == 3:
            x = x[None]
        return x.permute(0, 3, 1, 2).to(self.device)

    @torch.inference_mode()
    def __call__(self, img_a, img_b) -> float:
        a, b = self._prep(img_a), self._prep(img_b)
        if not graphs.enabled(self.device):
            return float(self.net(a, b)[0])
        key = (tuple(a.shape), tuple(b.shape), graphs.storage_key(self.net))
        return float(self._graphs.run(key, lambda inputs, g: self.net(inputs["a"], inputs["b"]), {"a": a, "b": b},
                                      on_repeat=True)[0])
