"""GAN models of the educational zoo (counterpart of the JAX package's
``models/gan.py``; the reference's ``notebooks/simple_gan.ipynb``,
``dcgan.ipynb`` and ``wgan-gp.ipynb``).

NCHW modules named as the flax ones. BatchNorm is flax's
(``models/layers.py:BatchNorm``: momentum 0.99, the biased batch variance
in the running statistics) and follows the module's ``train()`` / ``eval()``
mode, where JAX passes ``train=``. The MLP models take and give images
flattened in (h, w, c) order, as JAX flattens NHWC. ``Critic`` is the
DCGAN discriminator trunk at hidden 64, BatchNorm included, as the JAX code
builds it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import BatchNorm, leaky_relu

# the reference's weights_init (dcgan.ipynb cell 14) as the JAX package reads it: N(0, 0.02) on the
# conv kernels and on the BatchNorm scales
DCGAN_INIT_STD = 0.02


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C) in JAX's NHWC order; 2-D stays as it is."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) if x.ndim == 4 else x


class MLPGenerator(nn.Module):
    """Linear(z, 256) -> LeakyReLU(0.01) -> Linear(256, 784) -> tanh."""

    def __init__(self, z_dim: int = 64, hidden: Sequence[int] = (256,), out_dim: int = 784, slope: float = 0.01):
        super().__init__()
        dims = [z_dim, *hidden]
        for i, h in enumerate(hidden):
            self.add_module(f"fc{i}", nn.Linear(dims[i], h))
        self.n_hidden, self.slope = len(hidden), slope
        self.fc_out = nn.Linear(dims[-1], out_dim)

    def forward(self, z):
        x = z
        for i in range(self.n_hidden):
            x = leaky_relu(getattr(self, f"fc{i}")(x), self.slope)
        return torch.tanh(self.fc_out(x))


class MLPDiscriminator(nn.Module):
    """flatten -> Linear(784, 128) -> LeakyReLU(0.01) -> Linear(128, 1)
    logits (the sigmoid lives in the loss)."""

    def __init__(self, in_dim: int = 784, hidden: Sequence[int] = (128,), slope: float = 0.01):
        super().__init__()
        dims = [in_dim, *hidden]
        for i, h in enumerate(hidden):
            self.add_module(f"fc{i}", nn.Linear(dims[i], h))
        self.n_hidden, self.slope = len(hidden), slope
        self.fc_out = nn.Linear(dims[-1], 1)

    def forward(self, x):
        x = flatten_hwc(x)
        for i in range(self.n_hidden):
            x = leaky_relu(getattr(self, f"fc{i}")(x), self.slope)
        return self.fc_out(x)


class DCGANGenerator(nn.Module):
    """ConvT(z -> 4h, k3, s2) -> ConvT(4h -> 2h, k4, s1) -> ConvT(2h -> h, k3,
    s2), each + BatchNorm + ReLU, then ConvT(h -> c, k4, s2) + tanh, all
    unpadded: 1 -> 3 -> 6 -> 13 -> 28."""

    def __init__(self, z_dim: int = 64, out_ch: int = 1, hidden_dim: int = 64):
        super().__init__()
        h = hidden_dim
        cin = z_dim
        for i, (f, k, s) in enumerate(((4 * h, 3, 2), (2 * h, 4, 1), (h, 3, 2))):
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(cin, f, k, s))
            self.add_module(f"bn{i}", BatchNorm(f))
            cin = f
        self.deconv_out = nn.ConvTranspose2d(h, out_ch, 4, 2)

    def forward(self, z):
        x = z.reshape(z.shape[0], z.shape[-1], 1, 1)
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"deconv{i}")(x)))
        return torch.tanh(self.deconv_out(x))


class DCGANDiscriminator(nn.Module):
    """Conv(c -> h, k4, s2) + BN + LeakyReLU(0.2) -> Conv(h -> 2h, k4, s2) +
    BN + LeakyReLU(0.2) -> Conv(2h -> 1, k4, s2), unpadded (28 -> 13 -> 5 ->
    1); (N, 1) logits."""

    def __init__(self, hidden_dim: int = 16, in_ch: int = 1):
        super().__init__()
        h = hidden_dim
        cin = in_ch
        for i, f in enumerate((h, 2 * h)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, f, 4, 2))
            self.add_module(f"bn{i}", BatchNorm(f))
            cin = f
        self.conv_out = nn.Conv2d(2 * h, 1, 4, 2)

    def forward(self, x):
        for i in range(2):
            x = leaky_relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)), 0.2)
        x = self.conv_out(x)
        return flatten_hwc(x)


class Critic(nn.Module):
    """The WGAN-GP critic: the DCGAN trunk at hidden 64, linear output."""

    def __init__(self, hidden_dim: int = 64, in_ch: int = 1):
        super().__init__()
        self.trunk = DCGANDiscriminator(hidden_dim, in_ch)

    def forward(self, x):
        return self.trunk(x)
