"""Helpers shared by the port's tests (``tests/test_torch_port_*.py``)."""

import numpy as np
import jax

from dgm_img_super_resolution_tpu.models.factory import build_srdiff, init_srdiff_params


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
