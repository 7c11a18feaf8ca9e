"""Autoencoder and VAE of the educational models (counterpart of the JAX
package's ``models/autoencoder.py``; the reference's
``notebooks/simple_autoencoder.ipynb`` and its ``vae.ipynb`` stub).

NCHW modules named as the flax ones (``conv0``, ``fc``, ``deconv1`` ...),
so ``ckpt/jax_params.py:jax_module_params_to_state_dict`` carries a JAX
tree across by name. The encoder flattens its last feature map in (h, w, c)
order and the decoder unflattens its Dense output as (base, base, C), the
JAX package's NHWC orders, so the Dense weights carry across as they are.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.models.layers import same_pad
from dgm_img_super_resolution_tpu_torch.utils.draws import randn


class ConvEncoder(nn.Module):
    """3 x [Conv3x3 stride 2, flax SAME padding + ReLU] -> flatten -> Dense(latent)."""

    def __init__(self, latent_dim: int = 2, features: Sequence[int] = (32, 64, 128), in_ch: int = 1,
                 in_hw: int = 32):
        super().__init__()
        chans = [in_ch, *features]
        for i in range(len(features)):
            self.add_module(f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], 3, 2))
        hw = in_hw
        for _ in features:
            hw = -(-hw // 2)
        self.n_convs = len(features)
        self.fc = nn.Linear(features[-1] * hw * hw, latent_dim)

    def forward(self, x):
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(same_pad(x, 3, 2)))
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class ConvDecoder(nn.Module):
    """Dense(latent -> base^2 * 128) -> (base, base, 128) -> 3 x [ConvT(k3, s2,
    p1, op1) + ReLU] (128 -> 128 -> 64 -> 32) -> Conv3x3 SAME -> sigmoid."""

    def __init__(self, latent_dim: int, out_hw: int = 32, out_ch: int = 1,
                 features: Sequence[int] = (128, 128, 64, 32)):
        super().__init__()
        self.base = out_hw // 2 ** (len(features) - 1)
        self.c0 = features[0]
        self.fc = nn.Linear(latent_dim, self.base * self.base * features[0])
        for i in range(1, len(features)):
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(features[i - 1], features[i], 3, 2, 1,
                                                             output_padding=1))
        self.n_deconvs = len(features) - 1
        self.conv_out = nn.Conv2d(features[-1], out_ch, 3, padding=1)

    def forward(self, z):
        x = self.fc(z).reshape(z.shape[0], self.base, self.base, self.c0).permute(0, 3, 1, 2)
        for i in range(1, self.n_deconvs + 1):
            x = F.relu(getattr(self, f"deconv{i}")(x))
        return torch.sigmoid(self.conv_out(x))


class AutoEncoder(nn.Module):
    def __init__(self, latent_dim: int = 2, out_hw: int = 32, out_ch: int = 1):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = ConvEncoder(latent_dim, in_ch=out_ch, in_hw=out_hw)
        self.decoder = ConvDecoder(latent_dim, out_hw, out_ch)

    def forward(self, x):
        return self.decoder(self.encoder(x))

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)


class VAE(nn.Module):
    """The conv trunk with mu / logvar heads (one Dense of 2 x latent, split)
    and the reparameterised draw; ``eps`` is given, or drawn from
    ``generator``."""

    def __init__(self, latent_dim: int = 16, out_hw: int = 32, out_ch: int = 1):
        super().__init__()
        self.latent_dim = latent_dim
        self.trunk = ConvEncoder(latent_dim * 2, in_ch=out_ch, in_hw=out_hw)
        self.decoder = ConvDecoder(latent_dim, out_hw, out_ch)

    def encode(self, x):
        mu, logvar = self.trunk(x).chunk(2, dim=-1)
        return mu, logvar

    @staticmethod
    def reparameterize(mu, logvar, eps=None, generator: torch.Generator | None = None):
        if eps is None:
            eps = randn(mu.shape, generator, mu.device, mu.dtype)
        return mu + torch.exp(0.5 * logvar) * eps.to(mu.device, mu.dtype)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x, eps=None, generator: torch.Generator | None = None):
        mu, logvar = self.encode(x)
        return self.decode(self.reparameterize(mu, logvar, eps, generator)), mu, logvar
