"""The bf16 tail's route onto the warpgroup-MMA conv core
(``csrc/tail_fuse_wgmma.cu``), on the CPU.

The core's route computes the tail in two launches: the ConvT writing y
(``convt_plain``), then the reflect 3x3 whose epilogue hook applies Mish and
the 1x1 conv (``conv_mish_1x1_plain``). Those plain pieces are what
``tail_fuse_plain`` is made of: here they are held against it bit for bit in
bf16, and composed in float32 against the JAX package's ``tail_reference``
(2e-5 absolute + 2e-5 relative, as ``tests/test_torch_port_regions.py``).
The ConvT launch's loop order (one row phase a block, a 3-row halo box from
row j - 1 + a with zeros outside the image, the taps of ``convt_phase_taps``
at the TMA boxes' coordinates, the two column phases interleaved into
128-pixel rows) and the hook's 1x1 (four partial dots of 16 channels summed
in the shuffles' order) are emulated and held against ``F.conv_transpose2d``
and the plain 1x1.

The routing runs the wrapper's device path on CPU tensors: ``on_cpu``
answers False and fake C functions stand in for the libraries, so the tests
see which library and function each dtype and cout reaches, and that a
failing build or launch on the core's route raises.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ops.pallas.tail_fuse import tail_reference
from dgm_img_super_resolution_tpu_torch.models.layers import mish
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

from chip_smoke import tail_args

TOL = dict(rtol=2e-5, atol=2e-5)


def _rnd(t):
    """Round float32 values to bf16 and back, as the kernels' ``rnd``."""
    return t.to(torch.bfloat16).float()


def _tail_args(b, h, w, cout, dtype, seed):
    return tail_args(b, h, w, dtype, "cpu", seed=seed, cout=cout)


# ------------------------------------------------------------- the pieces
@pytest.mark.parametrize("b,h,w", [(1, 3, 5), (2, 6, 70)])
def test_pieces_compose_the_tail_bit_for_bit_in_bf16(b, h, w):
    """ConvT -> y, then 3x3 + Mish + 1x1 over y, equals ``tail_fuse_plain``
    exactly in bf16."""
    x, wt, bt, wf, bf, wo, bo = _tail_args(b, h, w, 3, torch.bfloat16, seed=h * w + b)
    y = tf.convt_plain(x, wt, bt)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (b, 64, 2 * h, 2 * w)
    assert torch.equal(tf.conv_mish_1x1_plain(y, wf, bf, wo, bo), tf.tail_fuse_plain(x, wt, bt, wf, bf, wo, bo))


@pytest.mark.parametrize("c,h,w", [(8, 5, 7), (64, 4, 6)])
def test_pieces_match_jax_tail_reference(c, h, w):
    """The two pieces composed in float32 against the JAX package's
    ``tail_reference``."""
    rng = np.random.default_rng(c + h + w)
    b = 2
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((c, c, 4, 4)) / np.sqrt(4 * c)).astype(np.float32)  # (I, O, kh, kw)
    wf = (rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)
    wo = (rng.standard_normal((3, c, 1, 1)) / np.sqrt(c)).astype(np.float32)
    bt, bf, bo = ((rng.standard_normal(n) * 0.2).astype(np.float32) for n in (c, c, 3))
    kt = np.transpose(wt[:, :, ::-1, ::-1], (2, 3, 0, 1))  # JAX: pre-flipped HWIO
    ref = tail_reference(jnp.asarray(x), jnp.asarray(kt), jnp.asarray(bt), jnp.asarray(np.transpose(wf, (2, 3, 1, 0))),
                         jnp.asarray(bf), jnp.asarray(wo[:, :, 0, 0].T), jnp.asarray(bo))
    t = torch.from_numpy
    y = tf.convt_plain(torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))), t(wt), t(bt))
    got = tf.conv_mish_1x1_plain(y, t(wf), t(bf), t(wo), t(bo))
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), np.asarray(ref), **TOL)


# ---------------------------------------------- the ConvT launch's loop order
def _convt_core(x, wt, tm=64, th=2):
    """The ConvT launch as the kernel computes it, in float32, without the
    bias: blocks of row phase a = 0 and 1, each holding the taps 8 a .. 8 a
    + 7 of ``convt_phase_taps`` seen as 16 boxes (the weight map's); tiles
    of ``th`` input rows x ``tm`` input pixels; per tile a halo box of 3
    input rows from j - 1 + a and tm + 8 pixels from l0 - 1, zero outside the
    image (as TMA fills it); warpgroup w's column phase pb is the sum over
    taps (u, v) of halo row w + u from pixel pb + v times tap 4 pb + 2 u + v
    of the resident 8; the two phases interleaved into a 2 tm-pixel row
    (pb = 0 even, 1 odd), stored at output row 2 (j + w) + a from pixel 2 l0,
    clipped to the image."""
    b_, c, h, w = x.shape
    boxes = tf.convt_phase_taps(wt, torch.float32).reshape(16, c, c)  # (tap, C_out, C_in)
    out = torch.full((b_, c, 2 * h, 2 * w), float("nan"))
    tiles = [(b, y0, x0) for b in range(b_) for y0 in range(0, h, th) for x0 in range(0, w, tm)]
    for a in (0, 1):
        resident = boxes[8 * a:8 * a + 8]
        for b, y0, x0 in tiles:
            box = torch.zeros(c, 3, tm + 8)
            for r in range(3):
                for p in range(tm + 8):
                    y, xx = y0 - 1 + a + r, x0 - 1 + p
                    if 0 <= y < h and 0 <= xx < w:
                        box[:, r, p] = x[b, :, y, xx]
            for wg in range(th):
                row = torch.zeros(2 * tm, c)
                for pb in (0, 1):
                    acc = torch.zeros(tm, c)
                    for tap in range(4):
                        u, v = tap // 2, tap % 2
                        acc += box[:, wg + u, pb + v:pb + v + tm].t() @ resident[4 * pb + tap].t()
                    row[pb::2] = acc
                if y0 + wg < h:
                    n = min(2 * tm, 2 * (w - x0))
                    out[b, :, 2 * (y0 + wg) + a, 2 * x0:2 * x0 + n] = row[:n].t()
    return out


@pytest.mark.parametrize("c,h,w,tm", [(64, 5, 67, 64), (16, 3, 9, 4)])
def test_convt_core_loop_order_and_weight_layout(c, h, w, tm):
    """The ConvT launch's loops and boxes, emulated on a ragged shape (a
    second tile in W, an odd H), equal ``F.conv_transpose2d``; every output
    element is written once."""
    g = torch.Generator().manual_seed(c + w)
    x = torch.randn(2, c, h, w, generator=g)
    wt = torch.randn(c, c, 4, 4, generator=g) / (4 * c**0.5)
    got = _convt_core(x, wt, tm=tm)
    assert not got.isnan().any()
    torch.testing.assert_close(got, F.conv_transpose2d(x, wt, stride=2, padding=1), rtol=1e-5, atol=1e-4)


# ------------------------------------------------- the 3x3's 1x1 hook
def _tail_hook(s, bf, wo, bo):
    """The Tail hook over conv sums ``s`` (P pixels, 64 channels, float32):
    m = rnd(mish(rnd(s + bf))); thread t of a pixel's quad takes channels 8 n
    + 2 t, + 1 (n < 8) and sums m times ``core_wo``'s rows in that order;
    the xor shuffles add lane t ^ 1's partial, then lane t ^ 2's, leaving
    one sum in all four lanes; lane t stores the outputs o < cout with o % 4
    == t, rnd(sum + bo)."""
    cout = wo.shape[0]
    m = _rnd(mish(_rnd(s + K.f32(bf, torch.bfloat16))))
    wk = tf.core_wo(wo, torch.bfloat16).float()
    seen, parts = [], []
    for t in range(4):
        p = torch.zeros(s.shape[0], wk.shape[1])
        for n in range(8):
            for e in range(2):
                c = 8 * n + 2 * t + e
                seen.append(c)
                p = p + m[:, c:c + 1] * wk[c]
        parts.append(p)
    assert sorted(seen) == list(range(64))
    lanes = [parts[t] + parts[t ^ 1] for t in range(4)]
    lanes = [lanes[t] + lanes[t ^ 2] for t in range(4)]
    assert all(torch.equal(lanes[0], lane) for lane in lanes)
    bo_k = K.f32(bo, torch.bfloat16)
    stored = {o: _rnd(lanes[t][:, o] + bo_k[o]) for t in range(4) for o in range(wk.shape[1])
              if o % 4 == t and o < cout}
    assert sorted(stored) == list(range(cout))
    return torch.stack([stored[o] for o in range(cout)], 1)


@pytest.mark.parametrize("cout", [3, 8])
def test_tail_hook_reduction_matches_the_plain_1x1(cout):
    """The hook's quad-split 1x1 over the conv's sums equals
    ``conv_mish_1x1_plain`` within bf16 rounding (one ulp of the output,
    from the sum orders of the 3x3 and the 1x1)."""
    b, h, w = 2, 6, 10
    x, wt, bt, wf, bf, wo, bo = _tail_args(b, h // 2, w // 2, cout, torch.bfloat16, seed=cout)
    y = tf.convt_plain(x, wt, bt)
    s = F.conv2d(F.pad(y.float(), (1, 1, 1, 1), mode="reflect"), K.f32(wf, torch.bfloat16))
    got = _tail_hook(s.permute(0, 2, 3, 1).reshape(-1, 64), bf, wo, bo)
    want = tf.conv_mish_1x1_plain(y, wf, bf, wo, bo).float()
    got = got.reshape(b, h, w, cout).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=2**-7 * want.abs().max().item())


@pytest.mark.parametrize("cout,width", [(1, 4), (3, 4), (4, 4), (5, 8), (8, 8)])
def test_core_wo_layout(cout, width):
    """The hook's 1x1 weight: (64, 4) up to cout 4, (64, 8) above, in bf16;
    row c holds channel c's weights to each output; zero past cout."""
    wo = torch.randn(cout, 64, 1, 1, generator=torch.Generator().manual_seed(cout))
    got = tf.core_wo(wo, torch.bfloat16)
    assert got.shape == (64, width) and got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got[:, :cout], wo[:, :, 0, 0].t().to(torch.bfloat16))
    assert not got[:, cout:].any()


# ---------------------------------------------------------------- routing
def _fake_libraries(monkeypatch, fail=None):
    """Stand-ins for the C functions: each call is recorded as (library,
    function, arguments) after checking the argument count against the
    declared signature, and returns 0. ``fail``: "library missing" raises
    when the conv core's library is asked for, "launch refused" returns 1
    from its functions."""
    calls = []

    def function(lib, fn, n_ptrs, n_ints, n_floats=0):
        if fail == "library missing" and lib == "tail_fuse_wgmma":
            raise RuntimeError(f"nvcc {lib}.cu failed")

        def call(*args):
            assert len(args) == 1 + n_ptrs + n_ints + n_floats + 1, (fn, len(args))
            calls.append((lib, fn, args))
            return 1 if fail == "launch refused" and lib == "tail_fuse_wgmma" else 0
        return call

    monkeypatch.setattr(K, "on_cpu", lambda *t: False)
    monkeypatch.setattr(K, "stream_ptr", lambda: 0)
    monkeypatch.setattr(tf, "function", function)
    return calls


CONVT = ("tail_fuse_wgmma", "dgmsr_convt_wgmma")
CONV_1X1 = ("tail_fuse_wgmma", "dgmsr_conv_mish_1x1_wgmma")
TILE = ("tail_fuse", "dgmsr_tail_fuse")


@pytest.mark.parametrize("dtype,cout,want", [(torch.bfloat16, 1, [CONVT, CONV_1X1]),
                                             (torch.bfloat16, 3, [CONVT, CONV_1X1]),
                                             (torch.bfloat16, 8, [CONVT, CONV_1X1]),
                                             (torch.bfloat16, 9, [TILE]), (torch.float32, 3, [TILE])])
def test_each_dtype_and_cout_reaches_one_tail_kernel(monkeypatch, dtype, cout, want):
    """bf16 with cout <= 8 runs the conv core's two launches and counts in
    ``launches_wgmma``: the ConvT writes y of twice x's size, the 3x3 reads
    that y and writes the output the wrapper returns, each told the width
    (and cout) and its image's shape. float32, and bf16 with more outputs,
    reach ``tail_fuse.cu``."""
    calls = _fake_libraries(monkeypatch)
    before = tf.tail_fuse.launches, tf.tail_fuse.launches_wgmma
    b, h, w = 2, 3, 5
    with torch.inference_mode():
        out = tf.tail_fuse(*_tail_args(b, h, w, cout, dtype, seed=cout))
    assert [(lib, fn) for lib, fn, _ in calls] == want
    core = want != [TILE]
    assert (tf.tail_fuse.launches, tf.tail_fuse.launches_wgmma) == (before[0] + 1, before[1] + core)
    assert out.dtype == dtype and tuple(out.shape) == (b, cout, 2 * h, 2 * w)
    assert out.is_contiguous(memory_format=torch.channels_last)
    if core:
        convt, conv = (a for _, _, a in calls)
        assert convt[5:-1] == (64, b, h, w)
        assert conv[1] == convt[4]  # y
        assert conv[6] == out.data_ptr() and conv[7:-1] == (64, cout, b, 2 * h, 2 * w)
    else:
        args = calls[0][2]
        assert args[9] == out.data_ptr() and args[10:-1] == (cout, b, h, w)


@pytest.mark.parametrize("failure", ["launch refused", "library missing"])
def test_the_core_route_raises_rather_than_falling_back(monkeypatch, failure):
    """A bf16 tail whose conv-core library fails to build, or whose launch
    is refused, raises: it never serves through ``tail_fuse.cu`` or the
    plain version, and counts nothing."""
    calls = _fake_libraries(monkeypatch, fail=failure)
    for plain in ("tail_fuse_plain", "convt_plain", "conv_mish_1x1_plain"):
        monkeypatch.setattr(tf, plain, lambda *a, _p=plain: pytest.fail(f"fell back to {_p}"))
    before = tf.tail_fuse.launches, tf.tail_fuse.launches_wgmma
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 1|failed"):
        tf.tail_fuse(*_tail_args(1, 2, 3, 3, torch.bfloat16, seed=0))
    assert TILE not in [(lib, fn) for lib, fn, _ in calls]
    assert (tf.tail_fuse.launches, tf.tail_fuse.launches_wgmma) == before
