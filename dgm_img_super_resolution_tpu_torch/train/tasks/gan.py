"""Adversarial training tasks: the simple GAN, DCGAN and WGAN-GP
(counterpart of the JAX package's ``train/tasks/gan.py``; the reference's
``simple_gan.ipynb``, ``dcgan.ipynb`` and ``wgan-gp.ipynb`` loops).

- GAN / DCGAN: alternating Adam updates with ``disc_loss = (BCE(D(fake), 0)
  + BCE(D(real), 1)) / 2`` and ``gen_loss = BCE(D(fake), 1)`` on logits.
- WGAN-GP: ``crit_repeats`` critic updates per generator update and the
  penalty ``gp_lambda * (||grad_x C(x_mix)|| - 1)^2`` at the eps-mix of
  real and fake, whose gradient is ``torch.autograd.grad(...,
  create_graph=True)`` of the critic's sum: a double backward.

One round (``train_step``) is K critic / discriminator updates, then one
generator update, as JAX's. The BatchNorm statistics are the modules'
buffers and move as JAX threads its ``batch_stats``: the discriminator sees
the fake and the real batch as two train-mode calls, one after the other;
the generator runs in train mode inside every critic update (under no
grad, its output detached) and in the generator update, so its statistics
move K + 1 times a round; the penalty's critic call and the generator
update's discriminator call run in eval mode, the penalty on the
statistics from before its update's two train-mode calls. Draws JAX takes
from ``fold_in`` keys come from a ``torch.Generator`` or a dict ``noise``
keyed ``(name, k)``: ``("z", k)`` the generator input of update k,
``("eps", k)`` its (N, 1, 1, 1) mix weights, ``("z_gen", 0)`` the
generator update's input.

On the card a round replays one captured CUDA graph (``jitted_step``, JAX's
``jax.jit(train_step)``), both Adams ``capturable`` with their rates in
device tensors. The GANs train on one device, as JAX's do: JAX's ``GANTask`` jits its
round without a mesh (its docstring's dp sharding is not what it runs), and
this task takes no ``mesh`` either.

Images are NCHW tensors, or NHWC numpy arrays (``data/mnist.py``), which
the task moves to its device; the simple GAN's generator gives
(N, H*W*C) rows in JAX's NHWC order, which ``generate`` reshapes to NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.graphs import GraphCache
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.models.gan import (
    DCGAN_INIT_STD,
    Critic,
    DCGANDiscriminator,
    DCGANGenerator,
    MLPDiscriminator,
    MLPGenerator,
    flatten_hwc,
)
from dgm_img_super_resolution_tpu_torch.models.layers import flax_init_
from dgm_img_super_resolution_tpu_torch.train.trainer import adam_state_dict, load_adam_state, make_adam

KINDS = ("gan", "dcgan", "wgan-gp")


@dataclasses.dataclass
class GANState:
    gen: nn.Module
    disc: nn.Module
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int = 0
    graphs: GraphCache = dataclasses.field(default_factory=GraphCache)  # the captured rounds (jitted_step)


def _bce_logits(logits: torch.Tensor, target_ones: bool) -> torch.Tensor:
    target = torch.ones_like(logits) if target_ones else torch.zeros_like(logits)
    return F.binary_cross_entropy_with_logits(logits, target)


def _draw_fn(noise: dict | None, generator: torch.Generator | None, device: torch.device) -> Callable:
    """``draw(name, k, shape)``: ``noise[(name, k)]``, or drawn from
    ``generator`` (uniform for ``"eps"``, normal otherwise)."""
    if noise is None:
        def draw(name, k, shape):
            fn = torch.rand if name == "eps" else torch.randn
            return fn(shape, generator=generator, device=device)
        return draw
    return lambda name, k, shape: noise[(name, k)].to(device, torch.float32)


class GANTask:
    """``kind``: ``"gan"`` (MLP), ``"dcgan"`` or ``"wgan-gp"``."""

    def __init__(self, hp: Hparams, kind: str = "dcgan", img_shape=(28, 28, 1),
                 device: str | torch.device | None = None):
        if kind not in KINDS:
            raise ValueError(f"GAN kind {kind!r} is none of {KINDS}")
        self.hp, self.kind = hp, kind
        self.img_shape = tuple(img_shape)  # (H, W, C), as JAX's
        self.device = resolve_device(device)
        # all three reference notebooks train with z_dim=64 (simple_gan cell 8, dcgan cell 10, wgan-gp cell 39)
        self.z_dim = int(hp.get("z_dim", 64))
        self.crit_repeats = int(hp.get("crit_repeats", 5)) if kind == "wgan-gp" else 1
        self.gp_lambda = float(hp.get("gp_lambda", 10.0))
        # the DCGAN convention Adam(2e-4, b1=0.5) (dcgan.ipynb cell 13); the simple GAN Adam(3e-4, b1=0.9)
        self.lr = float(hp.get("gan_lr", 2e-4 if kind != "gan" else 3e-4))
        self.b1 = 0.5 if kind != "gan" else 0.9

    # ------------------------------------------------------------------ init
    def _models(self) -> tuple[nn.Module, nn.Module]:
        h, w, c = self.img_shape
        if self.kind == "gan":
            return MLPGenerator(z_dim=self.z_dim, out_dim=h * w * c), MLPDiscriminator(in_dim=h * w * c)
        gen = DCGANGenerator(z_dim=self.z_dim, out_ch=c)
        return gen, (DCGANDiscriminator(in_ch=c) if self.kind == "dcgan" else Critic(in_ch=c))

    def init_state(self, seed: int = 0) -> GANState:
        """Fresh models drawn from ``seed`` (flax's defaults for the MLPs,
        N(0, 0.02) kernels and BatchNorm scales for the conv models) on the
        task's device, with their two Adam optimizers."""
        gen, disc = self._models()
        g = torch.Generator().manual_seed(seed)
        std = None if self.kind == "gan" else DCGAN_INIT_STD
        for m in (gen, disc):
            flax_init_(m, g, kernel_std=std, norm_scale_std=std)
            m.to(self.device)

        def adam(m):
            return make_adam(m.parameters(), self.lr, (self.b1, 0.999), self.device)

        return GANState(gen, disc, adam(gen), adam(disc))

    # --------------------------------------------------------------- helpers
    def _real(self, real) -> torch.Tensor:
        if isinstance(real, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(real)).to(self.device).permute(0, 3, 1, 2)
        return real.to(self.device)

    def _fake_like(self, fake: torch.Tensor, n: int) -> torch.Tensor:
        """The generator's output as the discriminator takes it: the MLP's
        rows as they are, the DCGAN's images NCHW."""
        if self.kind == "gan":
            return fake
        h, w, c = self.img_shape
        return fake.reshape(n, c, h, w)

    def _real_in(self, real: torch.Tensor) -> torch.Tensor:
        return flatten_hwc(real) if self.kind == "gan" else real

    def _penalty(self, disc, buffers, real_in, fake, eps, create_graph: bool) -> torch.Tensor:
        """mean((||grad_x C(x_mix)|| - 1)^2) with the critic in eval mode on
        ``buffers``' statistics."""
        mixed = (eps * real_in + (1.0 - eps) * fake).detach().requires_grad_(True)
        disc.eval()
        out = torch.func.functional_call(disc, buffers, (mixed,))
        (grad_x,) = torch.autograd.grad(out.sum(), mixed, create_graph=create_graph)
        gnorm = torch.sqrt((grad_x**2).sum(dim=(1, 2, 3)) + 1e-12)
        return ((gnorm - 1.0) ** 2).mean()

    def generate(self, state: GANState, n: int, z=None, generator: torch.Generator | None = None):
        """n images (n, C, H, W) from the generator in eval mode."""
        if z is None:
            z = torch.randn((n, self.z_dim), generator=generator, device=self.device)
        state.gen.eval()
        with torch.no_grad():
            out = state.gen(z.to(self.device, torch.float32))
        if self.kind == "gan":
            h, w, c = self.img_shape
            out = out.reshape(n, h, w, c).permute(0, 3, 1, 2)
        return out

    # ------------------------------------------------------------------ step
    def _disc_update(self, state: GANState, real: torch.Tensor, k: int, draw: Callable):
        n = real.shape[0]
        gen, disc = state.gen, state.disc
        gen.train()
        with torch.no_grad():
            fake = self._fake_like(gen(draw("z", k, (n, self.z_dim))), n)
        real_in = self._real_in(real)
        wgan = self.kind == "wgan-gp"
        before = {name: b.clone() for name, b in disc.named_buffers()} if wgan else None
        disc.train()
        c_fake = disc(fake)
        c_real = disc(real_in)
        extra = {}
        if wgan:
            gp = self._penalty(disc, before, real_in, fake, draw("eps", k, (n, 1, 1, 1)), create_graph=True)
            loss = c_fake.mean() - c_real.mean() + self.gp_lambda * gp
            extra = {"gp": gp.detach(), "w_dist": (c_real.mean() - c_fake.mean()).detach()}
        else:
            loss = 0.5 * (_bce_logits(c_fake, False) + _bce_logits(c_real, True))
        state.disc_opt.zero_grad(set_to_none=True)
        loss.backward()
        state.disc_opt.step()
        state.disc_opt.zero_grad(set_to_none=True)
        return loss.detach(), extra

    def _gen_update(self, state: GANState, n: int, draw: Callable) -> torch.Tensor:
        gen, disc = state.gen, state.disc
        gen.train()
        disc.eval()
        logits = disc(self._fake_like(gen(draw("z_gen", 0, (n, self.z_dim))), n))
        loss = -logits.mean() if self.kind == "wgan-gp" else _bce_logits(logits, True)
        params = list(gen.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        state.gen_opt.step()
        state.gen_opt.zero_grad(set_to_none=True)
        return loss.detach()

    def train_step(self, state: GANState, real, generator: torch.Generator | None = None, noise=None):
        """One adversarial round: ``crit_repeats`` discriminator / critic
        updates, then one generator update. Metrics stay on the device. On
        the card the round replays its captured graph (:meth:`jitted_step`)."""
        return self._jitted_step(state, real, generator, noise)

    def jitted_step(self) -> Callable:
        """The round as one captured CUDA graph, JAX's ``jitted_step``
        (``train/tasks/gan.py:228``): ``step(state, real, generator=None,
        noise=None) -> (state, metrics)``, captured after its first, eager
        run (``core/graphs.py``) and kept on the state: the K critic updates
        with the WGAN-GP penalty's double backward, the generator update,
        both capturable Adams and the BatchNorm statistics. On the CPU,
        under ``graphs.eager()`` and for ``noise`` that is not tensors it
        runs eagerly."""
        return self._jitted_step

    def _jitted_step(self, state: GANState, real, generator: torch.Generator | None = None, noise=None):
        real = self._real(real)
        noise_in = {} if noise is None else graphs.tensor_inputs("noise", noise)
        if noise_in is None or not graphs.enabled(self.device):
            metrics = self._round(state, real, generator, noise)
        else:
            def fn(inputs, g):
                return self._round(state, inputs["real"], g,
                                   None if noise is None else graphs.rebuild("noise", noise, inputs))

            key = ("round", tuple(real.shape), real.dtype, graphs.signature(noise))
            metrics = state.graphs.run(key, fn, {"real": real, **noise_in}, generator)
        state.step += 1
        return state, metrics

    def _round(self, state: GANState, real: torch.Tensor, generator, noise) -> dict:
        draw = _draw_fn(noise, generator, self.device)
        metrics = {}
        for k in range(self.crit_repeats):
            d_loss, extra = self._disc_update(state, real, k, draw)
            metrics.update(extra)
        metrics.update(disc_loss=d_loss, gen_loss=self._gen_update(state, real.shape[0], draw))
        return metrics

    def val_step(self, state: GANState, real, generator: torch.Generator | None = None, noise=None) -> dict:
        """The round's losses without updates, both models in eval mode
        (the reference's ``val_step``, wgan-gp.ipynb cell 37); draws
        ``("z", 0)`` and ``("eps", 0)``."""
        real = self._real(real)
        n = real.shape[0]
        draw = _draw_fn(noise, generator, self.device)
        gen, disc = state.gen, state.disc
        gen.eval()
        disc.eval()
        with torch.no_grad():
            fake = self._fake_like(gen(draw("z", 0, (n, self.z_dim))), n)
            real_in = self._real_in(real)
            c_fake, c_real = disc(fake), disc(real_in)
        if self.kind == "wgan-gp":
            gp = self._penalty(disc, {}, real_in, fake, draw("eps", 0, (n, 1, 1, 1)), create_graph=False)
            disc_loss = c_fake.mean() - c_real.mean() + self.gp_lambda * gp.detach()
            gen_loss = -c_fake.mean()
        else:
            disc_loss = 0.5 * (_bce_logits(c_fake, False) + _bce_logits(c_real, True))
            gen_loss = _bce_logits(c_fake, True)
        return {"disc_loss": disc_loss, "gen_loss": gen_loss}

    # ------------------------------------------------------------------- fit
    def fit(self, train_iter, epochs: int, steps_per_epoch: int, seed: int = 0, val_iter=None, val_steps: int = 0,
            state: GANState | None = None) -> tuple[GANState, dict]:
        """The epoch loop with train and validation losses (the shape of the
        reference's ``training_fn``, wgan-gp.ipynb cells 34-38): a fresh
        state from ``seed`` unless one is given, the draws from a generator
        seeded ``seed + 1`` on the device. The losses stay on the device
        until the epoch's end. Returns the state and per-epoch mean losses."""
        state = state if state is not None else self.init_state(seed)
        generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        results: dict[str, list] = {"gen_train_loss": [], "disc_train_loss": [],
                                    "gen_val_loss": [], "disc_val_loss": []}

        def epoch_means(ms, prefix):
            for name in ("gen", "disc"):
                results[f"{name}_{prefix}_loss"].append(float(torch.stack([m[f"{name}_loss"] for m in ms]).mean()))

        for _ in range(epochs):
            epoch_means([self.train_step(state, next(train_iter), generator)[1] for _ in range(steps_per_epoch)],
                        "train")
            if val_iter is not None and val_steps:
                epoch_means([self.val_step(state, next(val_iter), generator) for _ in range(val_steps)], "val")
        return state, results

    # ------------------------------------------------------------- model IO
    def save_model_info(self, state: GANState, path: str) -> str:
        """Write both models, both optimizers and the step as one checkpoint
        under ``path`` (the reference's ``save_model_info``, wgan-gp.ipynb
        cell 5), keeping only the newest."""
        from dgm_img_super_resolution_tpu_torch.ckpt.ckpt_io import save_checkpoint

        payload = {"gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
                   "gen_opt": adam_state_dict(state.gen_opt), "disc_opt": adam_state_dict(state.disc_opt),
                   "step": state.step}
        return save_checkpoint({"state": payload, "global_step": state.step}, path, state.step, num_ckpt_keep=1)

    def load_model_info(self, path: str) -> GANState | None:
        """The newest checkpoint under ``path`` as a state on the task's
        device, or None when there is none."""
        from dgm_img_super_resolution_tpu_torch.ckpt.ckpt_io import load_checkpoint

        ckpt, _ = load_checkpoint(path)
        if ckpt is None:
            return None
        saved = ckpt["state"]
        state = self.init_state(0)
        state.gen.load_state_dict(saved["gen"])
        state.disc.load_state_dict(saved["disc"])
        load_adam_state(state.gen_opt, saved["gen_opt"])
        load_adam_state(state.disc_opt, saved["disc_opt"])
        state.step = int(saved["step"])
        return state
