"""VGG19 feature extractor and perceptual loss (counterpart of the JAX
package's ``metrics/perceptual.py``).

The reference's ``VGGFeatureExtractor`` / ``PerceptualLoss``: VGG19
features up to torchvision's layer 34 (conv5_4, taken before its ReLU),
inputs in [-1, 1] normalised with the reference's shifted ImageNet
statistics, L1 between the feature maps. NCHW. Weight-gated like LPIPS:
:meth:`PerceptualLoss.maybe_create` returns ``None`` without a weights file
(the JAX package's ``.npz``), and :meth:`PerceptualLoss.from_torch_vgg19`
maps a torchvision ``vgg19`` state dict by name (torchvision is not
needed). The port's parameter names are the Flax module names,
``conv_<torchvision index>.weight`` / ``.bias``.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

# VGG19 up to torchvision features index 34 (conv5_4): (out_channels,
# torchvision layer index); "M" is a 2x2 max pool
_VGG19_PLAN = [
    (64, 0), (64, 2), "M",
    (128, 5), (128, 7), "M",
    (256, 10), (256, 12), (256, 14), (256, 16), "M",
    (512, 19), (512, 21), (512, 23), (512, 25), "M",
    (512, 28), (512, 30), (512, 32), (512, 34),
]


class VGG19Features(nn.Module):
    """VGG19 trunk to conv5_4, the last conv's output taken before its ReLU."""

    def __init__(self, use_input_norm: bool = True):
        super().__init__()
        self.use_input_norm = use_input_norm
        cin = 3
        for item in _VGG19_PLAN:
            if item != "M":
                ch, idx = item
                setattr(self, f"conv_{idx}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        # [-1, 1]-shifted ImageNet statistics (reference model.py:236-241)
        self.register_buffer("mean", torch.tensor([0.485 - 1.0, 0.456 - 1.0, 0.406 - 1.0]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229 * 2.0, 0.224 * 2.0, 0.225 * 2.0]).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        convs = [item for item in _VGG19_PLAN if item != "M"]
        for item in _VGG19_PLAN:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv_{item[1]}")(x)
            if item is not convs[-1]:
                x = F.relu(x)
        return x


class PerceptualLoss(nn.Module):
    """L1 on VGG19 features (reference ``PerceptualLoss``, model.py:255-269)."""

    def __init__(self, state_dict: dict | None = None):
        super().__init__()
        self.net = VGG19Features()
        if state_dict is not None:
            self.net.load_state_dict(state_dict, strict=True)

    @classmethod
    def maybe_create(cls, weights_path: str | None) -> "PerceptualLoss | None":
        """``None`` without a weights file; else the JAX package's ``.npz``."""
        if not weights_path or not os.path.exists(weights_path):
            return None
        from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_npz_to_state_dict

        return cls(jax_npz_to_state_dict(weights_path))

    @classmethod
    def from_torch_vgg19(cls, state_dict: dict) -> "PerceptualLoss":
        """From a torchvision ``vgg19().state_dict()`` (or its
        ``features.``-prefixed subset); keys past conv5_4 are ignored."""
        layers = {idx for item in _VGG19_PLAN if item != "M" for idx in [item[1]]}
        sd = {}
        for key, v in state_dict.items():
            k = key[len("features."):] if key.startswith("features.") else key
            parts = k.split(".")
            if len(parts) == 2 and parts[0].isdigit() and int(parts[0]) in layers and parts[1] in ("weight", "bias"):
                sd[f"conv_{parts[0]}.{parts[1]}"] = torch.as_tensor(v).detach().to("cpu", torch.float32)
        return cls(sd)

    def forward(self, high_resolution, fake_high_resolution):
        return torch.abs(self.net(high_resolution) - self.net(fake_high_resolution)).mean()
