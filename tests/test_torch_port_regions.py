"""The port's three kernel regions against the JAX package's references.

On CPU tensors ``block_chain3_stem``, ``block_chain3`` and ``tail_fuse`` run
their plain PyTorch versions; here they are held, in float32, against
``block_chain3_stem_reference``, ``block_chain3_reference`` and
``tail_reference`` (which the JAX package's own tests hold against the Pallas
kernels in interpret mode). Weights are made in PyTorch's layouts with numpy
and converted to the JAX layouts (HWIO; the ConvTranspose kernel spatially
flipped). Tolerance: 2e-5 absolute + 2e-5 relative, float32 sums taken in a
different order over at most 4 chained convs of K <= 576.

The weight layouts that the CUDA kernels read (``conv_taps``,
``convt_phase_taps`` and the stem's (27, C) matrix) are checked by emulating
the kernels' tap loops with einsums against ``F.conv2d`` /
``F.conv_transpose2d``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ops.pallas.block_chain import (
    block_chain3_reference,
    block_chain3_stem_reference,
)
from dgm_img_super_resolution_tpu.ops.pallas.tail_fuse import tail_reference
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels.block_chain import block_chain3, block_chain3_stem
from dgm_img_super_resolution_tpu_torch.ops.kernels.tail_fuse import convt_phase_taps, tail_fuse

TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(8, 8, 8), (8, 12, 20), (64, 8, 8), (64, 10, 6)]  # (C, H, W)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _hwio(w):
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


def _params(rng, c, cin=None):
    def conv(co, ci, k):
        return (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)).astype(np.float32)

    def vec(n, s=0.2):
        return (rng.standard_normal(n) * s).astype(np.float32)

    return conv, vec


@pytest.mark.parametrize("c,h,w", SHAPES)
@pytest.mark.parametrize("with_cond", [False, True])
def test_block_chain3_stem_matches_jax(c, h, w, with_cond):
    rng = np.random.default_rng(c * 100 + h + w)
    conv, vec = _params(rng, c)
    b = 2
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    wa, ba, wr, br = conv(c, 3, 3), vec(c), conv(c, 3, 1), vec(c)
    tv1, tv2 = vec((b, c), 0.5), vec((b, c), 0.5)
    wb, bb, wc, bc, wd, bd = conv(c, c, 3), vec(c), conv(c, c, 3), vec(c), conv(c, c, 3), vec(c)
    cond = rng.standard_normal((b, h, w, c)).astype(np.float32) if with_cond else None

    ref = block_chain3_stem_reference(
        jnp.asarray(x), _hwio(wa), jnp.asarray(ba), jnp.asarray(wr[:, :, 0, 0].T), jnp.asarray(br),
        jnp.asarray(tv1), jnp.asarray(tv2), _hwio(wb), jnp.asarray(bb), _hwio(wc), jnp.asarray(bc),
        _hwio(wd), jnp.asarray(bd), None if cond is None else jnp.asarray(cond),
    )
    t = torch.from_numpy
    got = block_chain3_stem(
        _nchw(x), t(wa), t(ba), t(wr), t(br), t(tv1), t(tv2), t(wb), t(bb), t(wc), t(bc),
        t(wd), t(bd), None if cond is None else _nchw(cond),
    )
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c,h,w", SHAPES)
def test_block_chain3_matches_jax(c, h, w):
    rng = np.random.default_rng(c + h * w)
    conv, vec = _params(rng, c)
    b = 2
    a_pre, r1 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    tv1, tv2 = vec((b, c), 0.5), vec((b, c), 0.5)
    wb, bb, wc, bc, wd, bd = conv(c, c, 3), vec(c), conv(c, c, 3), vec(c), conv(c, c, 3), vec(c)
    ref = block_chain3_reference(
        jnp.asarray(a_pre), jnp.asarray(r1), jnp.asarray(tv1), jnp.asarray(tv2),
        _hwio(wb), jnp.asarray(bb), _hwio(wc), jnp.asarray(bc), _hwio(wd), jnp.asarray(bd),
    )
    t = torch.from_numpy
    got = block_chain3(_nchw(a_pre), _nchw(r1), t(tv1), t(tv2), t(wb), t(bb), t(wc), t(bc), t(wd), t(bd))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c,h,w", SHAPES)
def test_tail_fuse_matches_jax(c, h, w):
    rng = np.random.default_rng(7 * c + h + 3 * w)
    conv, vec = _params(rng, c)
    b = 2
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((c, c, 4, 4)) / np.sqrt(4 * c)).astype(np.float32)  # (I, O, kh, kw)
    bt, wf, bf, wo, bo = vec(c), conv(c, c, 3), vec(c), conv(3, c, 1), vec(3)
    kt = np.transpose(wt[:, :, ::-1, ::-1], (2, 3, 0, 1))  # JAX: pre-flipped HWIO
    ref = tail_reference(
        jnp.asarray(x), jnp.asarray(kt), jnp.asarray(bt), _hwio(wf), jnp.asarray(bf),
        jnp.asarray(wo[:, :, 0, 0].T), jnp.asarray(bo),
    )
    t = torch.from_numpy
    got = tail_fuse(_nchw(x), t(wt), t(bt), t(wf), t(bf), t(wo), t(bo))
    assert tuple(got.shape) == (b, 3, 2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


# ------------------------------------------------- kernel weight layouts
def _emulate_taps(x, w_taps, taps, border):
    """The tiled conv's arithmetic: out[p] = sum over taps (dy, dx) of
    x[p + (dy - 1, dx - 1)] @ w_taps[tap].T, with x NCHW."""
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect" if border == "reflect" else "constant")
    h, w = x.shape[2:]
    out = 0
    for i, (dy, dx) in enumerate(taps):
        out = out + torch.einsum("bchw,oc->bohw", xp[:, :, dy:dy + h, dx:dx + w], w_taps[i])
    return out


@pytest.mark.parametrize("h,w", [(8, 8), (5, 11)])
def test_kernel_weight_layouts(h, w):
    g = torch.Generator().manual_seed(h * w)
    c = 8
    x = torch.randn(2, c, h, w, generator=g)

    wc = torch.randn(c, c, 3, 3, generator=g)
    taps9 = [(t // 3, t % 3) for t in range(9)]
    got = _emulate_taps(x, K.conv_taps(wc, torch.float32), taps9, "reflect")
    want = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    wt = torch.randn(c, c, 4, 4, generator=g)
    phases = convt_phase_taps(wt, torch.float32)
    want = F.conv_transpose2d(x, wt, stride=2, padding=1)
    for ph in range(4):
        a, b = ph >> 1, ph & 1
        taps = [(a + (t >> 1), b + (t & 1)) for t in range(4)]
        got = _emulate_taps(x, phases[ph], taps, "zeros")
        torch.testing.assert_close(got, want[:, :, a::2, b::2], rtol=1e-5, atol=1e-5)

    # the stem: (27, C) ordered (dy, dx, c_in) and the (3, C) residual
    x3 = torch.randn(2, 3, h, w, generator=g)
    wa, wr = torch.randn(c, 3, 3, 3, generator=g), torch.randn(c, 3, 1, 1, generator=g)
    wa_k = K.f32(wa.permute(2, 3, 1, 0).reshape(27, c), torch.float32)
    xp = F.pad(x3, (1, 1, 1, 1), mode="reflect")
    cols = torch.stack([xp[:, ci, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3) for ci in range(3)], dim=1)
    torch.testing.assert_close(torch.einsum("bjhw,jc->bchw", cols, wa_k),
                               F.conv2d(xp, wa), rtol=1e-5, atol=1e-5)
    wr_k = K.f32(wr[:, :, 0, 0].t(), torch.float32)
    torch.testing.assert_close(torch.einsum("bjhw,jc->bchw", x3, wr_k), F.conv2d(x3, wr),
                               rtol=1e-5, atol=1e-5)
