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
step, at the low-t end.

``interpolate`` mixes two images' ``q_sample`` at one timestep t and runs
the ancestral chain from t-1 down to 0 on the first image's condition;
its noise is ``(eps_1, eps_2, {t: eps_t})`` or drawn from a generator.

Training (``training_losses``, JAX ``gaussian.py:252-300``): one timestep per
row, drawn from the generator or passed in as a (B,) tensor, so rows of one
batch sit at different t. The schedule is then read per row from a float32
copy of each buffer on the batch's device (``_coef``), with no round trip to
the host; a sampler step, whose t is one int for the batch, reads its
scalars from the host arrays as before. The noise is drawn, or passed as a
tensor (the q noise; the posterior step's is drawn), a pair ``(eps,
eps_step)`` or a hook ``noise(None)`` -> eps, ``noise(t)`` -> eps_step.
The drawn ones come from ``utils/draws.py``: a ``RowDraws`` generator draws
them for a global batch and keeps this batch's rows of it.
Under ``fix_rrdb`` the encoder runs without grad (JAX's ``stop_gradient``).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.diffusion.schedule import Schedule
from dgm_img_super_resolution_tpu_torch.metrics.psnr_ssim import ssim as ssim_loss
from dgm_img_super_resolution_tpu_torch.utils.draws import normal_like, randint

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


def _train_noise(noise, x: torch.Tensor, generator: torch.Generator | None) -> NoiseHook:
    """Normalise the ``noise`` argument of ``training_losses`` into a hook:
    ``hook(None)`` the q noise, ``hook(t)`` the posterior step's. Drawn
    noise takes x's memory format (channels_last on the card)."""
    def draw(_t=None):
        return normal_like(x, generator)

    if noise is None:
        return draw
    if callable(noise):
        return noise
    if isinstance(noise, torch.Tensor):
        return lambda t: noise if t is None else draw()
    eps, eps_step = noise
    return lambda t: eps if t is None else eps_step


class GaussianDiffusion(nn.Module):
    def __init__(self, denoise_fn: nn.Module, rrdb_net: nn.Module | None, schedule: Schedule, *,
                 loss_type: str = "l1", res: bool = True, res_rescale: float = 2.0, clip_input: bool = True,
                 use_rrdb: bool = True, fix_rrdb: bool = True, aux_l1_loss: bool = True,
                 aux_ssim_loss: bool = False, aux_percep_loss: bool = False,
                 percep_loss_fn: Callable | None = None):
        super().__init__()
        self.denoise_fn = denoise_fn
        self.rrdb = rrdb_net
        self.schedule = schedule
        self.num_timesteps = schedule.num_timesteps
        self.loss_type = loss_type
        self.res = res
        self.res_rescale = res_rescale
        self.clip_input = clip_input
        self.use_rrdb = use_rrdb and rrdb_net is not None
        self.fix_rrdb = fix_rrdb
        self.aux_l1_loss = aux_l1_loss
        self.aux_ssim_loss = aux_ssim_loss
        self.aux_percep_loss = aux_percep_loss
        self.percep_loss_fn = percep_loss_fn
        self._buffers_on: dict[torch.device, dict[str, torch.Tensor]] = {}

    def _coef(self, name: str, t, x: torch.Tensor):
        """Schedule buffer ``name`` at ``t``: a float for an int ``t`` (a
        sampler step), else the (B, 1, 1, 1) rows gathered from the buffer's
        float32 copy on x's device."""
        if not isinstance(t, torch.Tensor):
            return float(getattr(self.schedule, name)[t])
        bufs = self._buffers_on.get(x.device)
        if bufs is None:
            bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(x.device)
                    for k, v in vars(self.schedule).items()}
            self._buffers_on[x.device] = bufs
        return bufs[name][t.to(x.device)].view(-1, *([1] * (x.ndim - 1)))

    # ------------------------------------------------------------ condition
    def rrdb_cond(self, img_lr, img_lr_up):
        """Run the condition encoder once. Returns (rrdb_out, cond); under
        ``fix_rrdb`` without grad."""
        if not self.use_rrdb:
            return img_lr_up, img_lr
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.fix_rrdb):
            out, feas = self.rrdb(img_lr, True)
            return out, torch.cat(feas[2::3], dim=1)

    def sample_prepare(self, img_lr, img_lr_up, noise=None, generator=None, shape=None):
        """Everything before the sampler loop: the RRDB condition (once), its
        projection with the up-projection folded in, and the initial state
        of ``shape`` (``img_lr_up``'s by default): the noise itself, or in
        the non-residual regime the noised ``img_lr_up`` at t = T - 1 (JAX
        ``:318-338``). A batch-1 condition under a larger ``shape`` is
        shared by every row, as JAX broadcasts it: its projection is
        repeated to the state's batch, which the kernel regions take. Returns
        ``(x, cond, rrdb_out, hook)``."""
        shape = tuple(shape) if shape is not None else tuple(img_lr_up.shape)
        hook = as_noise_hook(noise, shape, img_lr_up.device, generator)
        rrdb_out, cond = self.rrdb_cond(img_lr, img_lr_up)
        cond = self.denoise_fn.project(cond, img_lr_up)
        if cond.shape[0] == 1 < shape[0]:
            cond = torch.cat([cond] * shape[0])
        x = hook(None).to(img_lr_up.device, torch.float32)
        if not self.res:
            t0 = torch.full((shape[0],), self.num_timesteps - 1, dtype=torch.long, device=img_lr_up.device)
            x = self.q_sample(img_lr_up, t0, x)
        return x, cond, rrdb_out, hook

    def _eps(self, x, t: int, cond, img_lr_up):
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        return self.denoise_fn(x, tb, cond, img_lr_up, cond_projected=True, up_folded=True).float()

    # ------------------------------------------------------------- q process
    def q_mean_variance(self, x_start, t):
        """Mean, variance and log variance of q(x_t | x_0)."""
        acp = self._coef("alphas_cumprod", t, x_start)
        return (self._coef("sqrt_alphas_cumprod", t, x_start) * x_start, 1.0 - acp,
                self._coef("log_one_minus_alphas_cumprod", t, x_start))

    def q_sample(self, x_start, t, noise):
        """x_t ~ q(x_t | x_0) at per-row timesteps ``t`` (B,); where t is
        -1 the result is x_start itself, as in the JAX package."""
        t = t.to(x_start.device)
        tc = t.clamp(min=0)
        a = self._coef("sqrt_alphas_cumprod", tc, x_start)
        b = self._coef("sqrt_one_minus_alphas_cumprod", tc, x_start)
        return torch.where((t < 0).view(-1, 1, 1, 1), x_start, a * x_start + b * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        """x0 from eps at ``t``: an int (a sampler step) or per-row (B,)."""
        return (self._coef("sqrt_recip_alphas_cumprod", t, x_t) * x_t
                - self._coef("sqrt_recipm1_alphas_cumprod", t, x_t) * noise)

    def q_posterior(self, x_start, x_t, t):
        mean = (self._coef("posterior_mean_coef1", t, x_t) * x_start
                + self._coef("posterior_mean_coef2", t, x_t) * x_t)
        return (mean, self._coef("posterior_variance", t, x_t),
                self._coef("posterior_log_variance_clipped", t, x_t))

    def p_mean_variance(self, x, t, noise_pred, clip_denoised: bool = True):
        x_recon = self.predict_start_from_noise(x, t, noise_pred)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean, variance, log_variance = self.q_posterior(x_recon, x, t)
        return mean, variance, log_variance, x_recon

    def p_sample_from_pred(self, x, t, noise_pred, noise, clip_denoised: bool = True):
        """One ancestral step from a predicted eps at per-row timesteps
        ``t`` (B,), with step noise ``noise``: (x_{t-1}, x0)."""
        mean, _, log_variance, x0 = self.p_mean_variance(x, t, noise_pred, clip_denoised)
        nonzero = (t.to(x.device) > 0).to(x.dtype).view(-1, *([1] * (x.ndim - 1)))
        return mean + nonzero * torch.exp(0.5 * log_variance) * noise, x0

    def p_sample(self, x, t, cond, img_lr_up, noise, noise_pred=None, clip_denoised: bool = True,
                 cond_projected: bool = False):
        """One ancestral step at timesteps ``t`` (an int, or per row (B,))
        (JAX ``:310``): eps from the UNet unless given as ``noise_pred``;
        ``cond`` the RRDB features, or as ``sample_prepare`` returns them
        when ``cond_projected``; ``noise`` the step's noise (JAX draws it
        from its key). Returns (x_{t-1}, x0)."""
        t = torch.as_tensor(t, dtype=torch.long, device=x.device).expand(x.shape[0])
        if noise_pred is None:
            kw = dict(cond_projected=True, up_folded=True) if cond_projected else {}
            noise_pred = self.denoise_fn(x, t, cond, img_lr_up, **kw).float()
        return self.p_sample_from_pred(x, t, noise_pred, noise.to(x.device, torch.float32), clip_denoised)

    # -------------------------------------------------------------- training
    def p_losses(self, x_start, t, cond, img_lr_up, noise: NoiseHook):
        """The diffusion loss at per-row ``t``: (loss, x_tp1, eps_pred,
        x_t_pred, x_t_gt, x0_pred); the posterior step that gives x_t_pred
        is for viewing only and runs without grad."""
        eps = noise(None)
        x_tp1_gt = self.q_sample(x_start, t, eps)
        x_t_gt = self.q_sample(x_start, t - 1, eps)
        noise_pred = self.denoise_fn(x_tp1_gt, t, cond, img_lr_up).float()
        with torch.no_grad():
            x_t_pred, x0_pred = self.p_sample_from_pred(x_tp1_gt, t, noise_pred.detach(), noise(t))
        if self.loss_type == "l1":
            loss = (eps - noise_pred).abs().mean()
        elif self.loss_type == "l2":
            loss = ((eps - noise_pred) ** 2).mean()
        elif self.loss_type == "ssim":
            loss = (eps - noise_pred).abs().mean() + (1.0 - ssim_loss(eps, noise_pred))
        else:
            raise NotImplementedError(self.loss_type)
        return loss, x_tp1_gt, noise_pred, x_t_pred, x_t_gt, x0_pred

    def training_losses(self, img_hr, img_lr, img_lr_up, t=None, noise=None,
                        generator: torch.Generator | None = None):
        """The training forward (reference ``forward``, ``model.py:992-1021``)
        over NCHW batches in [-1, 1]. ``t``: None (drawn, one per row), an
        int for every row, or a (B,) tensor. Returns ``(losses, (x_tp1,
        x_t_gt, x_t) images, t)``."""
        b, dev = img_hr.shape[0], img_hr.device
        if t is None:
            t = randint(self.num_timesteps, (b,), generator, dev)
        elif not isinstance(t, torch.Tensor):
            t = torch.full((b,), int(t), dtype=torch.long)
        t = t.to(dev)
        rrdb_out, cond = self.rrdb_cond(img_lr, img_lr_up)
        x = self.img2res(img_hr, img_lr_up)
        loss, x_tp1, _, x_t, x_t_gt, _ = self.p_losses(x, t, cond, img_lr_up, _train_noise(noise, x, generator))
        losses = {"q": loss}
        if self.use_rrdb and not self.fix_rrdb:
            if self.aux_l1_loss:
                losses["aux_l1"] = (rrdb_out - img_hr).abs().mean()
            if self.aux_ssim_loss:
                losses["aux_ssim"] = 1.0 - ssim_loss(rrdb_out, img_hr)
            if self.aux_percep_loss and self.percep_loss_fn is not None:
                losses["aux_percep"] = self.percep_loss_fn(img_hr, rrdb_out)
        imgs = tuple(self.res2img(v.detach(), img_lr_up) for v in (x_tp1, x_t_gt, x_t))
        return losses, imgs, t

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

    def _ancestral_step(self, x, t: int, cond, img_lr_up, hook: NoiseHook):
        """One ancestral step at timestep ``t`` for the whole batch: (x_{t-1}, x0)."""
        eps = self._eps(x, t, cond, img_lr_up)
        x0 = self.predict_start_from_noise(x, t, eps).clamp(-1.0, 1.0)
        mean, _, log_var = self.q_posterior(x0, x, t)
        if t > 0:
            std = float(np.exp(np.float32(0.5) * np.float32(log_var)))
            return mean + std * hook(t).to(x.device), x0
        return mean, x0

    def sample_segment(self, x, cond, img_lr_up, ts, hook: NoiseHook):
        """Ancestral steps over ``ts`` (descending timesteps)."""
        for t in ts:
            x, _ = self._ancestral_step(x, t, cond, img_lr_up, hook)
        return x

    def sample(self, img_lr, img_lr_up, noise=None, generator=None, shape=None, save_intermediate: bool = False):
        """Ancestral sampling over all T steps. Returns (img, rrdb_out); with
        ``save_intermediate`` also ``(imgs, x0s)``, each step's image and its
        clipped x0 prediction as images, stacked over the T steps in the
        order they run (T - 1 first), (T, B, C, H, W) each (JAX
        ``:367-397``)."""
        x, cond, rrdb_out, hook = self.sample_prepare(img_lr, img_lr_up, noise, generator, shape)
        ts = range(self.num_timesteps - 1, -1, -1)
        if not save_intermediate:
            x = self.sample_segment(x, cond, img_lr_up, ts, hook)
            return self.res2img(x, img_lr_up), rrdb_out
        imgs, x0s = [], []
        for t in ts:
            x, x0 = self._ancestral_step(x, t, cond, img_lr_up, hook)
            imgs.append(self.res2img(x, img_lr_up))
            x0s.append(self.res2img(x0, img_lr_up))
        return self.res2img(x, img_lr_up), rrdb_out, (torch.stack(imgs), torch.stack(x0s))

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
                    generator=None, enc_interval: int = 1, shape=None):
        """DDIM over a strided timestep subset (eta=0: deterministic; eta=1
        over the full subsequence: the respaced ancestral chain), with
        encoder propagation when ``enc_interval`` > 1. ``shape``: the
        state's, as ``sample_prepare`` takes it (``img_lr_up``'s by default;
        e.g. several draws for a batch-1 condition); the serve passes none,
        so its graph keys do not carry it."""
        ts, ts_prev = self.ddim_timesteps(num_steps)
        x, cond, rrdb_out, hook = self.sample_prepare(img_lr, img_lr_up, noise, generator, shape)
        K = int(enc_interval or 1)
        n_div = (len(ts) // K) * K if K > 1 else 0
        if n_div:
            x = self.ddim_segment_encprop(x, cond, img_lr_up, ts[:n_div], ts_prev[:n_div], hook, eta, K)
        x = self.ddim_segment(x, cond, img_lr_up, ts[n_div:], ts_prev[n_div:], hook, eta)
        return self.res2img(x, img_lr_up), rrdb_out

    def interpolate(self, x1, x2, img_lr, img_lr_up, t: int | None = None, lam: float = 0.5, noise=None,
                    generator=None):
        """Latent mixing between two HR images x1, x2 (NCHW, [-1, 1])
        conditioned on ``img_lr`` (reference ``model.py:1093-1116``):
        ``(1 - lam) q(x1, t) + lam q(x2, t)``, then the ancestral chain
        from t-1 to 0. ``lam``: a float or a 0-d tensor, taken as float32
        on x1's device, as JAX's traced weight. ``noise``: ``(eps_1, eps_2,
        {t: eps_t})`` for the two ``q_sample`` draws and the steps; ``None``
        draws them from ``generator``."""
        b = x1.shape[0]
        t = self.num_timesteps - 1 if t is None else int(t)
        if noise is None:
            def hook(_t=None):
                return torch.randn(tuple(x1.shape), generator=generator, device=x1.device)

            e1, e2 = hook(), hook()
        else:
            e1, e2, steps = noise
            hook = lambda ti: steps[int(ti)]  # noqa: E731
        _, cond = self.rrdb_cond(img_lr, img_lr_up)
        cond = self.denoise_fn.project(cond, img_lr_up)
        tb = torch.full((b,), t, dtype=torch.long, device=x1.device)
        xt1 = self.q_sample(self.img2res(x1, img_lr_up), tb, e1.to(x1.device, torch.float32))
        xt2 = self.q_sample(self.img2res(x2, img_lr_up), tb, e2.to(x1.device, torch.float32))
        lam = torch.as_tensor(lam, dtype=torch.float32, device=x1.device)  # the mixing weights in float32
        x = (1.0 - lam) * xt1 + lam * xt2
        x = self.sample_segment(x, cond, img_lr_up, range(t - 1, -1, -1), hook)
        return self.res2img(x, img_lr_up)

    # ------------------------------------------------------- residual regime
    def res2img(self, img_, img_lr_up, clip_input: bool | None = None):
        """The residual back to an image; ``clip_input`` overrides the
        model's (JAX ``:559-573``)."""
        clip_input = self.clip_input if clip_input is None else clip_input
        if self.res:
            if clip_input:
                img_ = img_.clamp(-1.0, 1.0)
            img_ = img_ / self.res_rescale + img_lr_up
        return img_

    def img2res(self, x, img_lr_up, clip_input: bool | None = None):
        clip_input = self.clip_input if clip_input is None else clip_input
        if self.res:
            x = (x - img_lr_up) * self.res_rescale
            if clip_input:
                x = x.clamp(-1.0, 1.0)
        return x
