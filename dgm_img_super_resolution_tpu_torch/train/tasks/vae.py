"""AE, VAE and DDPM training tasks of the educational models (counterpart
of the JAX package's ``train/tasks/vae.py``; the reference's
``notebooks/simple_autoencoder.ipynb``, ``vae.ipynb`` and
``basic_diffusion``).

Each task gives ``train/trainer.py:Trainer`` a ``loss_fn(model, batch,
generator, **kw)`` over batches ``{"x": ...}`` (NHWC numpy from
``data/mnist.py:to_model_input``, NCHW on the device by the time the loss
sees them) and a seeded ``init_params(seed)`` with flax's default
initialisers. The AE and VAE take inputs in [0, 1] (sigmoid decoders), the
DDPM in [-1, 1]. Randomness the JAX package draws from a key comes from the
trainer's ``torch.Generator`` or is passed in: the VAE's ``eps``, the
DDPM's ``t`` and ``noise``.
"""

from __future__ import annotations

import torch

from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.diffusion.ddpm import DDPM
from dgm_img_super_resolution_tpu_torch.diffusion.schedule import make_schedule
from dgm_img_super_resolution_tpu_torch.models.autoencoder import VAE, AutoEncoder
from dgm_img_super_resolution_tpu_torch.models.ddpm_unet import DDPMUnet
from dgm_img_super_resolution_tpu_torch.models.layers import flax_init_
from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer


class _Task:
    """The model, its seeded init and the trainer; subclasses set ``model``
    and ``loss_fn``."""

    model: torch.nn.Module

    def __init__(self, hp: Hparams, device: str | torch.device | None = None):
        self.hp = hp
        self.device = device

    def init_params(self, seed: int = 0) -> torch.nn.Module:
        return flax_init_(self.model, torch.Generator().manual_seed(seed))

    def make_trainer(self, device: str | torch.device | None = None, mesh=None) -> Trainer:
        """The trainer on ``device`` (the task's by default) over ``mesh``
        (``make_mesh(hp['mesh_shape'])`` by default)."""
        return Trainer(self.hp, loss_fn=self.loss_fn, init_params_fn=self.init_params,
                       device=device if device is not None else self.device, mesh=mesh)


class AETask(_Task):
    """The conv autoencoder with its reconstruction MSE."""

    def __init__(self, hp: Hparams, img_hw: int = 32, img_ch: int = 1, latent_dim: int = 2,
                 device: str | torch.device | None = None):
        super().__init__(hp, device)
        self.model = AutoEncoder(latent_dim=latent_dim, out_hw=img_hw, out_ch=img_ch)
        self.img_hw, self.img_ch = img_hw, img_ch

    def loss_fn(self, model: AutoEncoder, batch: dict, generator: torch.Generator | None = None):
        x = batch["x"]
        loss = ((model(x) - x) ** 2).mean()
        return loss, {"recon_mse": loss}


class VAETask(_Task):
    """The VAE with the ELBO: the Bernoulli reconstruction NLL summed over
    pixels plus ``beta`` x KL(q(z|x) || N(0, I)), each averaged over the
    batch."""

    def __init__(self, hp: Hparams, img_hw: int = 32, img_ch: int = 1, latent_dim: int = 16, beta: float = 1.0,
                 device: str | torch.device | None = None):
        super().__init__(hp, device)
        self.model = VAE(latent_dim=latent_dim, out_hw=img_hw, out_ch=img_ch)
        self.img_hw, self.img_ch = img_hw, img_ch
        self.beta = beta

    def loss_fn(self, model: VAE, batch: dict, generator: torch.Generator | None = None, eps=None):
        """``eps``: the reparameterisation's N(0, I) draw (B, latent), or
        drawn from ``generator``."""
        x = batch["x"]
        recon, mu, logvar = model(x, eps, generator)
        tiny = 1e-6
        bce = -(x * torch.log(recon + tiny) + (1 - x) * torch.log(1 - recon + tiny))
        recon_nll = bce.sum(dim=(1, 2, 3)).mean()
        kl = 0.5 * (torch.exp(logvar) + mu**2 - 1.0 - logvar).sum(dim=-1).mean()
        return recon_nll + self.beta * kl, {"recon_nll": recon_nll, "kl": kl}

    @torch.no_grad()
    def sample(self, model: VAE, n: int = 16, z=None, generator: torch.Generator | None = None):
        """Decode ``z`` (n, latent), or n draws of N(0, I), on the model's device."""
        dev = next(model.parameters()).device
        if z is None:
            z = torch.randn((n, model.latent_dim), generator=generator, device=dev)
        return model.decode(z.to(dev, torch.float32))


class DDPMTask(_Task):
    """The DDPM UNet (``ddpm_dim``, mults 1|2|4) over a linear schedule of
    ``ddpm_timesteps`` (1e-4 to 2e-2, no residual regime)."""

    def __init__(self, hp: Hparams, img_hw: int = 32, img_ch: int = 1, device: str | torch.device | None = None):
        super().__init__(hp, device)
        self.img_hw, self.img_ch = img_hw, img_ch
        unet = DDPMUnet(dim=int(hp.get("ddpm_dim", 64)), out_dim=img_ch, dim_mults=(1, 2, 4), in_ch=img_ch)
        schedule = make_schedule(timesteps=int(hp.get("ddpm_timesteps", 1000)), beta_schedule="linear",
                                 beta_start=1e-4, beta_end=2e-2, res=False)
        self.model = self.ddpm = DDPM(unet, schedule)

    def loss_fn(self, model: DDPM, batch: dict, generator: torch.Generator | None = None, t=None, noise=None):
        """``t`` (B,) and ``noise`` as ``DDPM.loss`` takes them."""
        return model.loss(batch["x"], t=t, noise=noise, generator=generator), {}

    def sample(self, model: DDPM, n: int = 16, noise=None, generator: torch.Generator | None = None):
        """n images (n, C, H, W) by the T-step ancestral chain; ``noise`` is
        the samplers' hook."""
        return model.sample((n, self.img_ch, self.img_hw, self.img_hw), noise=noise, generator=generator)
