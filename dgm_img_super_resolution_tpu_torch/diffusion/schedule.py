"""Diffusion noise schedules and their precomputed buffers (counterpart of
the JAX package's ``diffusion/schedule.py``).

All seven beta schedules (``quad | linear | warmup10 | warmup50 | const |
jsd | cosine``). The twelve buffers are computed in float64 with numpy and
stored as float32 arrays; in residual mode with a linear schedule the last
beta is forced to 0.999.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _warmup_beta(beta_start: float, beta_end: float, timesteps: int, frac: float) -> np.ndarray:
    betas = beta_end * np.ones(timesteps, dtype=np.float64)
    warmup = int(timesteps * frac)
    betas[:warmup] = np.linspace(beta_start, beta_end, warmup, dtype=np.float64)
    return betas


def get_beta_schedule(
    timesteps: int,
    beta_schedule: str = "linear",
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
) -> np.ndarray:
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)
    elif beta_schedule == "warmup10":
        betas = _warmup_beta(beta_start, beta_end, timesteps, 0.1)
    elif beta_schedule == "warmup50":
        betas = _warmup_beta(beta_start, beta_end, timesteps, 0.5)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(timesteps, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(timesteps, 1, timesteps, dtype=np.float64)
    else:
        raise NotImplementedError(beta_schedule)
    return betas


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


BUFFERS = (
    "betas",
    "alphas_cumprod",
    "alphas_cumprod_prev",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
)


def schedule_arrays(
    timesteps: int = 100,
    beta_schedule: str = "cosine",
    beta_s: float = 0.008,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
    res: bool = True,
) -> dict[str, np.ndarray]:
    """The twelve buffers, each a float64 ``(T,)`` array."""
    if beta_schedule == "cosine":
        betas = cosine_beta_schedule(timesteps, s=beta_s)
    else:
        betas = get_beta_schedule(timesteps, beta_schedule, beta_start, beta_end)
        if res and beta_schedule == "linear":
            betas = betas.copy()
            betas[-1] = 0.999
    alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    return {
        "betas": betas,
        "alphas_cumprod": acp,
        "alphas_cumprod_prev": acp_prev,
        "sqrt_alphas_cumprod": np.sqrt(acp),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - acp),
        "log_one_minus_alphas_cumprod": np.log(1.0 - acp),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / acp),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / acp - 1.0),
        "posterior_variance": post_var,
        "posterior_log_variance_clipped": np.log(np.maximum(post_var, 1e-20)),
        "posterior_mean_coef1": betas * np.sqrt(acp_prev) / (1.0 - acp),
        "posterior_mean_coef2": (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
    }


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The buffers as float32 numpy arrays. The sampler reads one scalar of
    each per step on the host, so they never need to live on the device."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(**kwargs) -> Schedule:
    """Build a :class:`Schedule` (arguments as :func:`schedule_arrays`)."""
    arrays = schedule_arrays(**kwargs)
    return Schedule(**{k: arrays[k].astype(np.float32) for k in BUFFERS})
