"""The unconditional DDPM of the educational models: the simple noise
objective and ancestral sampling (counterpart of the JAX package's
``diffusion/ddpm.py``; the reference's ``basic_diffusion`` capability).

Over the port's ``diffusion/schedule.py`` buffers (float32 numpy). The loss
takes its timesteps and noise as tensors, or draws them from a
``torch.Generator``; the sampler takes the samplers' noise hook
(``diffusion/gaussian.py:as_noise_hook``): ``noise(None)`` is the start
and ``noise(t)`` the step noise of timestep t, which stand in for JAX's
split key and its ``fold_in(rng_steps, t)``. The last step (t = 0) adds no
noise and asks for none.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import as_noise_hook
from dgm_img_super_resolution_tpu_torch.diffusion.schedule import Schedule
from dgm_img_super_resolution_tpu_torch.utils.draws import randint, randn


class DDPM(nn.Module):
    """Holds the noise model as its submodule ``model``."""

    def __init__(self, model: nn.Module, schedule: Schedule, clip_denoised: bool = True):
        super().__init__()
        self.model = model
        self.schedule = schedule
        self.num_timesteps = schedule.num_timesteps
        self.clip_denoised = clip_denoised
        self._buffers_on: dict[torch.device, dict[str, torch.Tensor]] = {}
        self._graphs = graphs.GraphCache()  # the captured samplers, by shape

    def _rows(self, name: str, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Buffer ``name`` at per-row timesteps ``t`` as (B, 1, 1, 1), read
        from the buffers' float32 copy on x's device."""
        bufs = self._buffers_on.get(x.device)
        if bufs is None:
            bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(x.device)
                    for k, v in vars(self.schedule).items()}
            self._buffers_on[x.device] = bufs
        return bufs[name][t.to(x.device)].view(-1, *([1] * (x.ndim - 1)))

    def q_sample(self, x_start, t, noise):
        return (self._rows("sqrt_alphas_cumprod", t, x_start) * x_start
                + self._rows("sqrt_one_minus_alphas_cumprod", t, x_start) * noise)

    def loss(self, x_start, t=None, noise=None, generator: torch.Generator | None = None):
        """Mean squared error of the predicted noise at per-row timesteps
        ``t`` (drawn uniformly from [0, T) when None)."""
        b, dev = x_start.shape[0], x_start.device
        if t is None:
            t = randint(self.num_timesteps, (b,), generator, dev)
        t = t.to(dev)
        if noise is None:
            noise = randn(x_start.shape, generator, dev)
        noise = noise.to(dev, torch.float32)
        pred = self.model(self.q_sample(x_start, t, noise), t).float()
        return ((noise - pred) ** 2).mean()

    def p_sample_step(self, x, t: int, noise: torch.Tensor | None):
        """One ancestral step at timestep ``t`` for the whole batch; ``noise``
        is not read at t = 0."""
        s = self.schedule
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = self.model(x, tb).float()
        x0 = float(s.sqrt_recip_alphas_cumprod[t]) * x - float(s.sqrt_recipm1_alphas_cumprod[t]) * eps
        if self.clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        mean = float(s.posterior_mean_coef1[t]) * x0 + float(s.posterior_mean_coef2[t]) * x
        if t == 0:
            return mean
        std = float(np.exp(np.float32(0.5) * s.posterior_log_variance_clipped[t]))
        return mean + std * noise.to(x.device, torch.float32)

    @torch.no_grad()
    def sample(self, shape, noise=None, generator: torch.Generator | None = None):
        """Ancestral sampling of ``shape`` (N, C, H, W) over all T steps, on
        the model's device. On the card the whole chain is one captured
        graph per shape, noise signature and the model's tensors' addresses
        (``core/graphs.py``; JAX's ``lax.scan`` over T,
        ``diffusion/ddpm.py:66-76``), captured at a key's second call
        (``on_repeat``: a one-off sample pays no capture) and replayed from
        the third; eager on the CPU, under ``graphs.eager()`` and for a
        callable hook."""
        device = next(self.model.parameters()).device
        shape = tuple(shape)
        noise_in = {} if noise is None else graphs.tensor_inputs("noise", noise)

        def chain(inputs, g):
            hook = as_noise_hook(graphs.rebuild("noise", noise, inputs) if noise_in else noise, shape, device, g)
            x = hook(None).to(device, torch.float32)
            for t in range(self.num_timesteps - 1, -1, -1):
                x = self.p_sample_step(x, t, hook(t) if t > 0 else None)
            return x

        if noise_in is None or not graphs.enabled(device):
            return chain(noise_in or {}, generator)
        key = ("sample", shape, graphs.signature(noise), graphs.storage_key(self.model))
        return self._graphs.run(key, chain, noise_in, generator, on_repeat=True)
