"""Kernel row 8, ``fused_group_norm`` (GroupNorm + affine + optional SiLU),
on the CPU: the port's wrapper runs its plain version here, held against the
JAX package's Pallas kernel in interpret mode (as ``tests/test_sd_pipeline.py``
runs it) on the same numpy inputs, in both layouts the port takes (NCHW
held contiguous or channels_last; JAX takes NHWC).

Tolerances: float32, 1e-5 absolute + 1e-5 relative (the same sums and
formula, var = E[x^2] - mean^2, in another order; outputs are of order 1);
bfloat16 input, 1e-2 absolute + 1e-2 relative (one bf16 rounding of the
output, 2^-8 relative, either side of a tie). ``F.group_norm`` (Welford's
variance) is held at 1e-4 as a yardstick only.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ops.pallas.groupnorm import fused_group_norm as jax_fused_group_norm
from dgm_img_super_resolution_tpu_torch.ops.kernels.group_norm import fused_group_norm

CASES = [  # (N, C, H, W, groups, eps)
    (2, 32, 8, 8, 8, 1e-6),
    (1, 64, 6, 10, 32, 1e-5),
    (2, 16, 5, 7, 4, 1e-5),
]


def _inputs(n, c, h, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h, w, c)) * 2.0 + 0.5).astype(np.float32)  # NHWC, off-centre
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _port_layout(x_nhwc, channels_last):
    t = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # a channels_last view
    return t if channels_last else t.contiguous()


@pytest.mark.parametrize("n,c,h,w,groups,eps", CASES)
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("channels_last", [False, True])
def test_matches_the_pallas_kernel(n, c, h, w, groups, eps, act, channels_last):
    x, scale, bias = _inputs(n, c, h, w, seed=c + h + w)
    ref = jax_fused_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=groups, eps=eps,
                               act=act, interpret=True)
    xt = _port_layout(x, channels_last)
    got = fused_group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), groups=groups, eps=eps, act=act)
    assert got.shape == xt.shape and got.dtype == torch.float32
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels_last", [False, True])
def test_bfloat16_matches_the_pallas_kernel(channels_last):
    x, scale, bias = _inputs(2, 32, 6, 8, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax_fused_group_norm(xb, jnp.asarray(scale), jnp.asarray(bias), groups=8, act="silu", interpret=True)
    xt = _port_layout(np.array(xb.astype(jnp.float32)), channels_last).to(torch.bfloat16)
    got = fused_group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), groups=8, act="silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_close_to_torch_group_norm():
    x, scale, bias = _inputs(2, 64, 9, 9, seed=7)
    xt, s, b = _port_layout(x, False), torch.from_numpy(scale), torch.from_numpy(bias)
    torch.testing.assert_close(fused_group_norm(xt, s, b, groups=32, act="silu"),
                               F.silu(F.group_norm(xt, 32, s, b, 1e-5)), rtol=1e-4, atol=1e-4)


def test_refusals():
    x = torch.zeros(1, 48, 4, 4)
    s = torch.ones(48)
    with pytest.raises(ValueError, match="multiple of groups"):
        fused_group_norm(x, s, s, groups=32)
    with pytest.raises(ValueError, match="act"):
        fused_group_norm(x, s, s, groups=16, act="gelu")
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        fused_group_norm(x[0], s, s, groups=16)
