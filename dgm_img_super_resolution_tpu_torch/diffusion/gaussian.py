"""Gaussian diffusion samplers of the SRDiff residual regime (counterpart of
the JAX package's ``diffusion/gaussian.py``).

``GaussianDiffusion`` holds the UNet (``denoise_fn``) and the RRDB encoder
(``rrdb``) as submodules, so its ``state_dict`` carries the reference
checkpoint's ``denoise_fn.*`` / ``rrdb.*`` names. The schedule buffers live
on the host as float32 numpy arrays: the sampler reads one scalar of each per
step. The sampler carry is a plain (B,3,H,W) float32 tensor; each step calls
the UNet once and updates the carry in float32.

Noise comes from an explicit ``torch.Generator`` on the carry's device, or
from a noise hook: ``noise=(x_T, {t: eps_t})`` or a callable ``noise(t)``
that returns the initial state for ``t=None`` and the step noise of
timestep ``t`` otherwise. The hook lets a test feed both frameworks one
stream. The noise of a step is asked for by its timestep, so a run split
into segments (``sample_segment``, ``ddim_segment``: the progress path)
gives exactly the whole run's result.

Encoder propagation (``ddim_sample(..., enc_interval=K)``): the UNet's down
path runs at the first timestep of each group of K DDIM steps and its
features are reused by the K decodes of the group, each at its own
timestep; a remainder of the steps that K does not divide runs exactly, per
step, at the low-t end. ``interpolate`` and the training losses are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.diffusion.schedule import Schedule

NoiseHook = Callable[[int | None], torch.Tensor]


def as_noise_hook(noise, shape, device, generator: torch.Generator | None) -> NoiseHook:
    """Normalise the ``noise`` argument of the samplers into a callable."""
    if noise is None:
        return lambda t: torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if callable(noise):
        return noise
    x_t, steps = noise
    steps: Mapping[int, torch.Tensor]
    return lambda t: x_t if t is None else steps[int(t)]


class GaussianDiffusion(nn.Module):
    def __init__(self, denoise_fn: nn.Module, rrdb_net: nn.Module | None, schedule: Schedule, *,
                 res: bool = True, res_rescale: float = 2.0, clip_input: bool = True):
        super().__init__()
        self.denoise_fn = denoise_fn
        self.rrdb = rrdb_net
        self.schedule = schedule
        self.num_timesteps = schedule.num_timesteps
        self.res = res
        self.res_rescale = res_rescale
        self.clip_input = clip_input

    # ------------------------------------------------------------ condition
    def rrdb_cond(self, img_lr, img_lr_up):
        """Run the condition encoder once. Returns (rrdb_out, cond)."""
        if self.rrdb is None:
            return img_lr_up, img_lr
        out, feas = self.rrdb(img_lr, True)
        return out, torch.cat(feas[2::3], dim=1)

    def sample_prepare(self, img_lr, img_lr_up, noise=None, generator=None):
        """Everything before the sampler loop: the RRDB condition (once), its
        projection with the up-projection folded in, and the initial state.
        Returns ``(x, cond, rrdb_out, hook)``."""
        shape = tuple(img_lr_up.shape)
        hook = as_noise_hook(noise, shape, img_lr_up.device, generator)
        rrdb_out, cond = self.rrdb_cond(img_lr, img_lr_up)
        cond = self.denoise_fn.project(cond, img_lr_up)
        x = hook(None).to(img_lr_up.device, torch.float32)
        if not self.res:
            t0 = torch.full((shape[0],), self.num_timesteps - 1, dtype=torch.long)
            x = self.q_sample(img_lr_up, t0, x)
        return x, cond, rrdb_out, hook

    def _eps(self, x, t: int, cond, img_lr_up):
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        return self.denoise_fn(x, tb, cond, img_lr_up, cond_projected=True, up_folded=True).float()

    # ------------------------------------------------------------- q process
    def q_sample(self, x_start, t, noise):
        """x_t ~ q(x_t | x_0) at per-batch timesteps ``t``; where t is -1
        the result is x_start itself, as in the JAX package."""
        s = self.schedule
        idx = t.cpu().numpy()
        tc = np.maximum(idx, 0)
        a = torch.from_numpy(s.sqrt_alphas_cumprod[tc]).to(x_start.device)[:, None, None, None]
        b = torch.from_numpy(s.sqrt_one_minus_alphas_cumprod[tc]).to(x_start.device)[:, None, None, None]
        keep = torch.from_numpy(idx < 0).to(x_start.device)[:, None, None, None]
        return torch.where(keep, x_start, a * x_start + b * noise)

    def predict_start_from_noise(self, x_t, t: int, noise):
        s = self.schedule
        return float(s.sqrt_recip_alphas_cumprod[t]) * x_t - float(s.sqrt_recipm1_alphas_cumprod[t]) * noise

    def q_posterior(self, x_start, x_t, t: int):
        s = self.schedule
        mean = float(s.posterior_mean_coef1[t]) * x_start + float(s.posterior_mean_coef2[t]) * x_t
        return mean, float(s.posterior_variance[t]), float(s.posterior_log_variance_clipped[t])

    # -------------------------------------------------------------- sampling
    def _encode(self, x, t: int, cond, img_lr_up):
        """The UNet's down path at ``t``: (skips, bottleneck)."""
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        return self.denoise_fn(x, tb, cond, img_lr_up, cond_projected=True, up_folded=True, mode="encode")

    def _decode(self, enc, t: int):
        """The UNet's mid block, up path and final convs at ``t`` from
        cached down-path features; eps in float32."""
        x = enc[1]
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        return self.denoise_fn(None, tb, None, mode="decode", enc_feats=enc).float()

    def sample_segment(self, x, cond, img_lr_up, ts, hook: NoiseHook):
        """Ancestral steps over ``ts`` (descending timesteps)."""
        for t in ts:
            eps = self._eps(x, t, cond, img_lr_up)
            x0 = self.predict_start_from_noise(x, t, eps).clamp(-1.0, 1.0)
            mean, _, log_var = self.q_posterior(x0, x, t)
            if t > 0:
                std = float(np.exp(np.float32(0.5) * np.float32(log_var)))
                x = mean + std * hook(t).to(x.device)
            else:
                x = mean
        return x

    def sample(self, img_lr, img_lr_up, noise=None, generator=None):
        """Ancestral sampling over all T steps. Returns (img, rrdb_out)."""
        x, cond, rrdb_out, hook = self.sample_prepare(img_lr, img_lr_up, noise, generator)
        x = self.sample_segment(x, cond, img_lr_up, range(self.num_timesteps - 1, -1, -1), hook)
        return self.res2img(x, img_lr_up), rrdb_out

    def ddim_timesteps(self, num_steps: int | None = None):
        """The strided (descending) DDIM timesteps and their successors (-1
        ends the chain), as int lists."""
        T = self.num_timesteps
        num_steps = num_steps or T
        ts = np.linspace(0, T - 1, num_steps, dtype=np.float32).round().astype(np.int64)[::-1]
        return [int(v) for v in ts], [int(v) for v in ts[1:]] + [-1]

    def ddim_update(self, x, ti: int, tp: int, eps, eta: float, hook: NoiseHook):
        """One DDIM x_t -> x_prev update from a predicted eps (x0 clipped).
        Scalars are computed in float32, as in the reference."""
        f = np.float32
        acp = self.schedule.alphas_cumprod
        a_t = acp[ti]
        a_prev = acp[tp] if tp >= 0 else f(1.0)
        x0 = ((x - float(np.sqrt(f(1.0) - a_t)) * eps) / float(np.sqrt(a_t))).clamp(-1.0, 1.0)
        eps = (x - float(np.sqrt(a_t)) * x0) / float(np.sqrt(f(1.0) - a_t))
        sigma = f(eta) * np.sqrt((f(1.0) - a_prev) / (f(1.0) - a_t)) * np.sqrt(f(1.0) - a_t / a_prev)
        c_dir = np.sqrt(np.maximum(f(1.0) - a_prev - sigma * sigma, f(0.0)))
        x = float(np.sqrt(a_prev)) * x0 + float(c_dir) * eps
        if sigma > 0:
            x = x + float(sigma) * hook(ti).to(x.device)
        return x

    def ddim_segment(self, x, cond, img_lr_up, ts, ts_prev, hook: NoiseHook, eta: float = 0.0):
        """DDIM steps over a slice of the strided timesteps."""
        for ti, tp in zip(ts, ts_prev):
            x = self.ddim_update(x, ti, tp, self._eps(x, ti, cond, img_lr_up), eta, hook)
        return x

    def ddim_segment_encprop(self, x, cond, img_lr_up, ts, ts_prev, hook: NoiseHook, eta: float,
                             enc_interval: int):
        """DDIM with encoder propagation over a slice whose length
        ``enc_interval`` divides: per group of K steps one encode at the
        group's first timestep, then K decodes, each at its own timestep."""
        K = int(enc_interval)
        if len(ts) % K:
            raise ValueError(f"{len(ts)} steps do not divide into groups of {K}")
        for g in range(0, len(ts), K):
            enc = self._encode(x, ts[g], cond, img_lr_up)
            for ti, tp in zip(ts[g: g + K], ts_prev[g: g + K]):
                x = self.ddim_update(x, ti, tp, self._decode(enc, ti), eta, hook)
        return x

    def ddim_sample(self, img_lr, img_lr_up, num_steps=None, eta: float = 0.0, noise=None,
                    generator=None, enc_interval: int = 1):
        """DDIM over a strided timestep subset (eta=0: deterministic; eta=1
        over the full subsequence: the respaced ancestral chain), with
        encoder propagation when ``enc_interval`` > 1."""
        ts, ts_prev = self.ddim_timesteps(num_steps)
        x, cond, rrdb_out, hook = self.sample_prepare(img_lr, img_lr_up, noise, generator)
        K = int(enc_interval or 1)
        n_div = (len(ts) // K) * K if K > 1 else 0
        if n_div:
            x = self.ddim_segment_encprop(x, cond, img_lr_up, ts[:n_div], ts_prev[:n_div], hook, eta, K)
        x = self.ddim_segment(x, cond, img_lr_up, ts[n_div:], ts_prev[n_div:], hook, eta)
        return self.res2img(x, img_lr_up), rrdb_out

    # ------------------------------------------------------- residual regime
    def res2img(self, img_, img_lr_up):
        if self.res:
            if self.clip_input:
                img_ = img_.clamp(-1.0, 1.0)
            img_ = img_ / self.res_rescale + img_lr_up
        return img_

    def img2res(self, x, img_lr_up):
        if self.res:
            x = (x - img_lr_up) * self.res_rescale
            if self.clip_input:
                x = x.clamp(-1.0, 1.0)
        return x
