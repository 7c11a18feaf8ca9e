"""Helpers shared by the port's tests (``tests/test_torch_port_*.py``)."""

import numpy as np
import jax
import torch

from dgm_img_super_resolution_tpu.models.factory import build_srdiff, init_srdiff_params


def hwio(w: np.ndarray) -> np.ndarray:
    """A PyTorch (O, I, kh, kw) conv weight in JAX's HWIO layout."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def random_jax_params(hp, seed):
    """A JAX SRDiff param tree for ``hp`` as nested dicts of numpy arrays:
    kernels N(0, 1/fan_in), biases N(0, 0.1) (the JAX init zeroes biases,
    which would hide a dropped bias). The tree's shapes come from tracing the
    JAX init, which is much cheaper here than compiling it."""
    d = build_srdiff(hp)
    shapes = jax.eval_shape(lambda: init_srdiff_params(d, jax.random.PRNGKey(0), hp, hr_size=32))
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "bias":
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            else:
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return d, fill(shapes)


def jax_noise(key, shape_nhwc, ts):
    """The JAX samplers' noise stream, as NCHW tensors for the port's hook."""
    k_init, k_steps = jax.random.split(key)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))  # noqa: E731
    x_t = to_t(jax.random.normal(k_init, shape_nhwc))
    steps = {int(t): to_t(jax.random.normal(jax.random.fold_in(k_steps, int(t)), shape_nhwc)) for t in ts}
    return x_t, steps


def sd_jax_noise(key, n, h, w, ts):
    """The JAX SD pipeline's draws, as NCHW tensors for the port's hook:
    the initial latents, the LR augmentation noise and the step noise of
    each timestep in ``ts``."""
    rng_prep, rng_steps = jax.random.split(key)
    rng_lat, rng_aug = jax.random.split(rng_prep)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))  # noqa: E731
    lat = jax.random.normal(rng_lat, (n, h, w, 4))
    aug = jax.random.normal(rng_aug, (n, h, w, 3))
    steps = {int(t): to_t(jax.random.normal(jax.random.fold_in(rng_steps, int(t)), (n, h, w, 4))) for t in ts}
    return to_t(lat), to_t(aug), steps


# Tiny SD configs under the published schemas (as tests/test_sd_torch_parity.py)
UNET_TINY = {
    "in_channels": 7, "out_channels": 4, "block_out_channels": [32, 64], "layers_per_block": 2,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "UpBlock2D"],
    "attention_head_dim": 2, "cross_attention_dim": 64, "only_cross_attention": [False, True],
    "num_class_embeds": 17,
}
VAE_TINY = {
    "in_channels": 3, "out_channels": 3, "block_out_channels": [32, 64], "layers_per_block": 2,
    "latent_channels": 4, "legacy_attention_keys": True, "scaling_factor": 0.08333,
}
CLIP_TINY = {
    "vocab_size": 1024, "hidden_size": 64, "intermediate_size": 256, "num_hidden_layers": 3,
    "num_attention_heads": 4, "max_position_embeddings": 77, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
}


def random_published_state_dict(shapes, seed):
    """Random float32 numpy weights for every key of a published-schema
    inventory: norm scales near 1, biases and embeddings small, kernels
    N(0, 1/fan_in)."""
    g = np.random.default_rng(seed)
    sd = {}
    for key, shp in shapes.items():
        if key.endswith(".bias"):
            v = 0.02 * g.standard_normal(shp)
        elif len(shp) == 1:
            v = 1.0 + 0.05 * g.standard_normal(shp)
        elif "embedding" in key and "time_embedding" not in key:
            v = 0.05 * g.standard_normal(shp)
        else:
            v = g.standard_normal(shp) / np.sqrt(int(np.prod(shp[1:])))
        sd[key] = v.astype(np.float32)
    return sd


def jit_quick(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's backend optimisations
    off: the same float32 operations, compiled in about half the time (the
    tiny training graphs of the train tests run once or a few times)."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0,
                                             "xla_llvm_disable_expensive_passes": True})
