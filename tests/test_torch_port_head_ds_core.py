"""The bf16 Downsample and head on the warpgroup-MMA conv core
(``csrc/head_ds_wgmma.cu``), and ``q_sample`` at t = -1, on the CPU.

On the core's route the Downsample fold's stride-2 conv is one launch
(``ds_plain``), and the head writes the chain's (h1, r1) in one launch
(``head_h1_plain``), so the h1 pass drops out. Those plain pieces are held,
composed as the kernels run them, against the regions' plain versions bit
for bit in bf16, and against the JAX package's
``block_chain3_stem_ds_reference`` / ``block_chain3_head_reference`` in
float32 (2e-5 absolute + 2e-5 relative, as
``tests/test_torch_port_chain_core.py``: float32 sums in another order over
at most 5 chained convs). The two kernels' loop orders are emulated and held
against ``F.conv2d``: the head's K in 64-channel slices from two sources,
rounded and restarted at the source boundary, with the 1x1 on the centre tap
of the same halo boxes; the Downsample's even and odd column phases with the
reflect patch at index -1. In float32 the emulation must equal the plain
piece to float32 sum order (1e-5); with the kernel's bf16 rounding points
it must agree with the bf16 plain piece at the card's bf16 tolerance
(``chip_smoke.BF16_TOL`` of max |plain|).

The routing runs the wrappers' device path on CPU tensors with fake C
functions, as ``tests/test_torch_port_chain_core.py`` does.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dgm_img_super_resolution_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from dgm_img_super_resolution_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from dgm_img_super_resolution_tpu.ops.pallas.block_chain import (
    block_chain3_head_reference,
    block_chain3_stem_ds_reference,
)
from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import GaussianDiffusion
from dgm_img_super_resolution_tpu_torch.diffusion.schedule import make_schedule
from dgm_img_super_resolution_tpu_torch.models.layers import mish
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

from chip_smoke import BF16_TOL, Regions

TOL = dict(rtol=2e-5, atol=2e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _hwio(w):
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1.0)).item()


def _head_args(cs, b, h, w, dtype, seed):
    """(x, skip, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd) of the head
    region with C_s = cs, 64 outputs, random as ``Regions`` makes them."""
    g = torch.Generator().manual_seed(seed)

    def act():
        return torch.randn(b, cs, h, w, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)

    def conv(co, ci, k):
        return torch.randn(co, ci, k, k, generator=g) / (ci * k * k) ** 0.5

    def vec(*shape, s=0.1):
        return (torch.randn(shape, generator=g) * s).to(dtype if len(shape) == 2 else torch.float32)

    return (act(), act(), conv(64, 2 * cs, 3), vec(64), conv(64, 2 * cs, 1), vec(64), vec(b, 64, s=0.5),
            vec(b, 64, s=0.5), conv(64, 64, 3), vec(64), conv(64, 64, 3), vec(64), conv(64, 64, 3), vec(64))


# ------------------------------------------------ the plain pieces compose


@pytest.mark.parametrize("cs", [64, 128])
@pytest.mark.parametrize("b,h,w", [(1, 3, 5), (2, 6, 10)])
def test_head_pieces_compose_the_region_bit_for_bit_in_bf16(cs, b, h, w):
    """head -> (h1, r1) -> the chain's three convs equals the head region's
    plain version exactly."""
    args = _head_args(cs, b, h, w, torch.bfloat16, seed=cs + h)
    x, skip, wa, ba, wr, br, tv1, tv2, *convs = args
    got = bc.chain_from_h1_plain(*bc.head_h1_plain(x, skip, wa, ba, wr, br, tv1), tv2, *convs)
    assert torch.equal(got, bc.block_chain3_head_plain(*args))


@pytest.mark.parametrize("b,h,w", [(1, 4, 6), (2, 10, 18)])
def test_ds_piece_composes_the_region_bit_for_bit_in_bf16(b, h, w):
    """The stem chain, then ``ds_plain`` over its output, equals the
    Downsample fold's plain version exactly (both outputs)."""
    r = Regions(b, h, w, torch.bfloat16, "cpu", seed=h * w + b)
    out, ds = bc.block_chain3_stem_ds_plain(*r.stem_ds)
    assert torch.equal(out, bc.block_chain3_stem_plain(*r.stem))
    assert torch.equal(ds, bc.ds_plain(out, *r.stem_ds[-2:]))


@pytest.mark.parametrize("cs,h,w", [(64, 5, 7), (128, 4, 6)])
def test_head_route_matches_jax_head_reference(cs, h, w):
    """The core's route in float32 (the head writing h1 and r1, then the
    chain's three convs) against ``block_chain3_head_reference``."""
    rng = np.random.default_rng(cs + h)
    b, c = 2, 64

    def conv(co, ci, k):
        return (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)).astype(np.float32)

    def vec(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x, skip = (rng.standard_normal((b, h, w, cs)).astype(np.float32) for _ in range(2))
    wa, ba, wr, br = conv(c, 2 * cs, 3), vec(c), conv(c, 2 * cs, 1), vec(c)
    tv1, tv2, wb, bb, wc, bc_, wd, bd = vec(b, c, s=0.5), vec(b, c, s=0.5), conv(c, c, 3), vec(c), conv(c, c, 3), \
        vec(c), conv(c, c, 3), vec(c)
    a = jnp.asarray
    ref = block_chain3_head_reference(a(x), a(skip), _hwio(wa), a(ba), a(wr[:, :, 0, 0].T), a(br), a(tv1), a(tv2),
                                      _hwio(wb), a(bb), _hwio(wc), a(bc_), _hwio(wd), a(bd))
    t = torch.from_numpy
    h1, r1 = bc.head_h1_plain(_nchw(x), _nchw(skip), t(wa), t(ba), t(wr), t(br), t(tv1))
    got = bc.chain_from_h1_plain(h1, r1, t(tv2), t(wb), t(bb), t(wc), t(bc_), t(wd), t(bd))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("h,w", [(6, 10), (4, 4)])
def test_ds_route_matches_jax_stem_ds_reference(h, w):
    """The Downsample fold on the core's route in float32 (the stem chain,
    then ``ds_plain``) against ``block_chain3_stem_ds_reference``."""
    r = Regions(2, h, w, torch.float32, "cpu", seed=h + w)
    x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc_, wd, bd, cond, wds, bds = r.stem_ds
    h1, r1 = bc.stem_h1_plain(x, wa, ba, wr, br, tv1)
    out = bc.chain_from_h1_plain(h1, r1, tv2, wb, bb, wc, bc_, wd, bd, cond)
    ds = bc.ds_plain(out, wds, bds)
    a = lambda t_: jnp.asarray(t_.numpy())  # noqa: E731
    ref_out, ref_ds = block_chain3_stem_ds_reference(
        a(x.permute(0, 2, 3, 1)), _hwio(wa.numpy()), a(ba), a(wr[:, :, 0, 0].T), a(br), a(tv1), a(tv2),
        _hwio(wb.numpy()), a(bb), _hwio(wc.numpy()), a(bc_), _hwio(wd.numpy()), a(bd), a(cond.permute(0, 2, 3, 1)),
        _hwio(wds.numpy()), a(bds))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(_nhwc(ds), np.asarray(ref_ds), **TOL)


# ---------------------------------------------- the kernels' loop orders


def _box(src, b, c0, y0, x0, rows, px):
    """64 channels from c0 of ``rows`` x ``px`` pixels from (y0, x0), zero
    outside the image (TMA's fill), then reflect-patched where the box holds
    the border (x = -1 from 1, x = W from W - 2; then the same for rows)."""
    _, _, h, w = src.shape
    box = torch.zeros(64, rows, px)
    for r in range(rows):
        for p in range(px):
            y, x = y0 + r, x0 + p
            if 0 <= y < h and 0 <= x < w:
                box[:, r, p] = src[b, c0:c0 + 64, y, x]
    for p in range(px):
        if x0 + p in (-1, w):
            box[:, :, p] = box[:, :, p + (2 if x0 + p == -1 else -2)]
    for r in range(rows):
        if y0 + r in (-1, h):
            box[:, r] = box[:, r + (2 if y0 + r == -1 else -2)]
    return box


def _head_core(x, skip, wa, ba, wr, br, tv1, rnd, tm=8, th=2):
    """(h1, r1) as the head kernel computes them, with ``rnd`` at its
    rounding points: tiles of ``th`` rows x ``tm`` pixels; K slices k of 64
    channels, x's then skip's, each one halo box of (th + 2) x (tm + 8) from
    (y0 - 1, x0 - 1); per slice, tap rows dy and taps dx against the weight
    slab (64, 64, 3) at (64 k, 0, 3 dy) of ``K.conv_taps(wa)``, and at dy = 1
    the 1x1's slab of the slice against the centre tap (box row w + 1 from
    pixel 1). After x's last slice both sums are rounded (the 3x3's with
    ba) and stashed, and skip's first slice restarts them."""
    b_, cs, h, w = x.shape
    taps = K.conv_taps(wa, torch.float32)  # (9, 64, 2 cs)
    w1 = wr[:, :, 0, 0].float()  # (64, 2 cs)
    h1, r1 = torch.full((b_, 64, h, w), float("nan")), torch.full((b_, 64, h, w), float("nan"))
    kx = cs // 64
    for b in range(b_):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tm):
                acc, accr = torch.zeros(th, tm, 64), torch.zeros(th, tm, 64)
                for k in range(2 * kx):
                    if k == kx:  # the source boundary
                        st3, str_ = rnd(acc + ba), rnd(accr)
                        acc, accr = torch.zeros(th, tm, 64), torch.zeros(th, tm, 64)
                    src, c0 = (x, 64 * k) if k < kx else (skip, 64 * (k - kx))
                    box = _box(src.float(), b, c0, y0 - 1, x0 - 1, th + 2, tm + 8)
                    for dy in range(3):
                        slab = taps[3 * dy:3 * dy + 3, :, 64 * k:64 * (k + 1)]
                        for dx in range(3):
                            for row in range(th):
                                acc[row] += box[:, row + dy, dx:dx + tm].t() @ slab[dx].t()
                        if dy == 1:
                            for row in range(th):
                                accr[row] += box[:, row + 1, 1:1 + tm].t() @ w1[:, 64 * k:64 * (k + 1)].t()
                a_pre = rnd(st3 + rnd(acc))
                hv = rnd(mish(a_pre) + tv1[b].float())
                rv = rnd(rnd(str_ + rnd(accr)) + br)
                for row in range(th):
                    if y0 + row < h:
                        n = min(tm, w - x0)
                        h1[b, :, y0 + row, x0:x0 + n] = hv[row, :n].t()
                        r1[b, :, y0 + row, x0:x0 + n] = rv[row, :n].t()
    return h1, r1


def _ds_core(x, wds, bds, rnd, tm=8):
    """The Downsample as its kernel computes it: items of one output row x
    ``tm`` pixels; a stage of the even and the odd column phase (columns
    2 i and 2 i + 1), each a box of 3 input rows (2 oy - 1 ..) x (tm + 8)
    phase pixels from index ox0 - 1, zero outside; at ox0 = 0 odd index -1
    is patched from odd index 0 (column -1 from column 1), at oy = 0 row -1
    from row 1; tap dx = 1 reads the even box from pixel 1, dx = 0 and 2 the
    odd box from pixels 0 and 1."""
    b_, c, h, w = x.shape
    ho, wo = h // 2, w // 2
    taps = K.conv_taps(wds, torch.float32)
    phases = (x.float()[:, :, :, 0::2], x.float()[:, :, :, 1::2])
    out = torch.full((b_, c, ho, wo), float("nan"))
    for b in range(b_):
        for oy in range(ho):
            for ox0 in range(0, wo, tm):
                box = [torch.zeros(64, 3, tm + 8) for _ in phases]
                for ph, src in enumerate(phases):
                    for r in range(3):
                        for p in range(tm + 8):
                            y, i = 2 * oy - 1 + r, ox0 - 1 + p
                            if 0 <= y < h and 0 <= i < wo:
                                box[ph][:, r, p] = src[b, :, y, i]
                if ox0 == 0:
                    box[1][:, :, 0] = box[1][:, :, 1]
                if oy == 0:
                    for ph in range(2):
                        box[ph][:, 0] = box[ph][:, 2]
                acc = torch.zeros(tm, 64)
                for dy in range(3):
                    for dx in range(3):
                        src, p0 = (box[0], 1) if dx == 1 else (box[1], dx // 2)
                        acc += src[:, dy, p0:p0 + tm].t() @ taps[3 * dy + dx].t()
                n = min(tm, wo - ox0)
                out[b, :, oy, ox0:ox0 + n] = rnd(acc + bds)[:n].t()
    return out


@pytest.mark.parametrize("cs,b,h,w", [(64, 1, 3, 10), (128, 2, 4, 9)])
def test_head_kernel_loop_order(cs, b, h, w):
    """The head kernel's loops and boxes on a ragged shape (a second tile in
    W, an odd H): in float32 they equal ``head_h1_plain``; with the kernel's
    bf16 rounding points they agree with it in bf16."""
    x, skip, wa, ba, wr, br, tv1 = _head_args(cs, b, h, w, torch.float32, seed=cs + w)[:7]
    got = _head_core(x, skip, wa, ba, wr, br, tv1, rnd=lambda t: t)
    for g, want in zip(got, bc.head_h1_plain(x, skip, wa, ba, wr, br, tv1)):
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
    x16, s16, t16 = x.to(torch.bfloat16), skip.to(torch.bfloat16), tv1.to(torch.bfloat16)
    got = _head_core(x16, s16, _bf16(wa), _bf16(ba), _bf16(wr), _bf16(br), t16, rnd=_bf16)
    for g, want in zip(got, bc.head_h1_plain(x16, s16, wa, ba, wr, br, t16)):
        assert _rel(g, want) <= BF16_TOL


@pytest.mark.parametrize("b,h,w", [(2, 6, 20), (1, 2, 2)])
def test_ds_kernel_loop_order(b, h, w):
    """The Downsample kernel's column phases and reflect patch on a ragged
    output (a second tile in W) and at the smallest even input: in float32
    they equal ``F.conv2d`` on the reflect-padded input at stride 2; with
    its bf16 rounding they agree with ``ds_plain`` in bf16."""
    g = torch.Generator().manual_seed(h * w)
    x = torch.randn(b, 64, h, w, generator=g)
    wds, bds = torch.randn(64, 64, 3, 3, generator=g) / 24, torch.randn(64, generator=g) * 0.1
    got = _ds_core(x, wds, bds, rnd=lambda t: t)
    torch.testing.assert_close(got, F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wds, bds, stride=2),
                               rtol=1e-5, atol=1e-5)
    x16 = x.to(torch.bfloat16)
    assert _rel(_ds_core(x16, _bf16(wds), _bf16(bds), rnd=_bf16), bc.ds_plain(x16, wds, bds)) <= BF16_TOL


# --------------------------------------------------------- the routing


def _fake_libraries(monkeypatch, fail=None):
    """Stand-ins for the C functions, as in
    ``tests/test_torch_port_chain_core.py``: each call is recorded as
    (library, function, arguments) after checking the argument count, and
    returns 0. ``fail``: "library missing" raises when ``head_ds_wgmma`` is
    asked for, "launch refused" returns 1 from its functions."""
    calls = []

    def function(lib, fn, n_ptrs, n_ints, n_floats=0):
        if fail == "library missing" and lib == "head_ds_wgmma":
            raise RuntimeError(f"nvcc {lib}.cu failed")

        def call(*args):
            assert len(args) == 1 + n_ptrs + n_ints + n_floats + 1, (fn, len(args))
            calls.append((lib, fn, args))
            return 1 if fail == "launch refused" and lib == "head_ds_wgmma" else 0
        return call

    monkeypatch.setattr(K, "on_cpu", lambda *t: False)
    monkeypatch.setattr(K, "stream_ptr", lambda: 0)
    monkeypatch.setattr(bc, "function", function)
    return calls


HEAD_ROUTES = [  # (C_s, dtype, the C functions called in order)
    (64, torch.bfloat16, ["dgmsr_head_wgmma", "dgmsr_chain3_wgmma"]),
    (128, torch.bfloat16, ["dgmsr_head_wgmma", "dgmsr_chain3_wgmma"]),
    (192, torch.bfloat16, ["dgmsr_head", "dgmsr_h1", "dgmsr_chain3_wgmma"]),
    (128, torch.float32, ["dgmsr_head", "dgmsr_block_chain3"]),
]


@pytest.mark.parametrize("cs,dtype,want", HEAD_ROUTES)
def test_head_route_by_dtype_and_width(monkeypatch, cs, dtype, want):
    """bf16 at C_s = 64 and 128 runs the head on the conv core, which writes
    the h1 and r1 the chain's core launches read (no h1 pass) and is told
    C_s and the shape; bf16 at other C_s and float32 keep
    ``block_chain.cu``'s two streamed convs. ``launches_head_wgmma`` counts
    the calls on the core."""
    calls = _fake_libraries(monkeypatch)
    before = bc.block_chain3_head.launches_head_wgmma
    b, h, w = 2, 5, 7
    with torch.inference_mode():
        out = bc.block_chain3_head(*_head_args(cs, b, h, w, dtype, seed=cs))
    assert [fn for _, fn, _ in calls] == want
    on_core = want[0] == "dgmsr_head_wgmma"
    assert bc.block_chain3_head.launches_head_wgmma == before + on_core
    assert out.shape == (b, 64, h, w) and out.dtype == dtype
    if on_core:
        args = {fn: a for _, fn, a in calls}
        head, chain = args["dgmsr_head_wgmma"], args["dgmsr_chain3_wgmma"]
        assert head[10:14] == (cs, b, h, w)
        assert chain[1:3] == head[8:10]  # h1, r1


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "dgmsr_ds_wgmma"), (torch.float32, "dgmsr_stem_ds")])
def test_ds_route_by_dtype(monkeypatch, dtype, want):
    """The Downsample reads the chain's output and writes ds_out at half its
    H and W: bf16 on the conv core (``launches_ds_wgmma``), float32 on
    ``block_chain.cu``."""
    calls = _fake_libraries(monkeypatch)
    before = bc.block_chain3_stem_ds.launches_ds_wgmma
    r = Regions(2, 6, 10, dtype, "cpu", seed=3)
    with torch.inference_mode():
        out, ds = bc.block_chain3_stem_ds(*r.stem_ds)
    ds_call = calls[-1]
    assert ds_call[1] == want
    assert ds_call[2][1] == out.data_ptr() and ds_call[2][4] == ds.data_ptr() and ds_call[2][5:8] == (2, 6, 10)
    assert ds.shape == (2, 64, 3, 5) and ds.is_contiguous(memory_format=torch.channels_last)
    assert bc.block_chain3_stem_ds.launches_ds_wgmma == before + (dtype == torch.bfloat16)


PLAINS = ["block_chain3_plain", "block_chain3_stem_plain", "block_chain3_stem_ds_plain", "block_chain3_head_plain",
          "chain_from_h1_plain", "h1_plain", "stem_plain", "stem_h1_plain", "head_plain", "head_h1_plain", "ds_plain"]


@pytest.mark.parametrize("name", ["block_chain3_stem_ds", "block_chain3_head"])
@pytest.mark.parametrize("failure", ["launch refused", "library missing"])
def test_the_head_ds_core_raises_rather_than_falling_back(monkeypatch, name, failure):
    """A bf16 call whose ``head_ds_wgmma`` library fails to build, or whose
    launch there is refused, raises: it never runs ``block_chain.cu``'s
    streamed conv or a plain version, and counts nothing."""
    calls = _fake_libraries(monkeypatch, fail=failure)
    for plain in PLAINS:
        monkeypatch.setattr(bc, plain, lambda *a, _p=plain: pytest.fail(f"fell back to {_p}"))
    wrapper = getattr(bc, name)
    counters = ("launches", "launches_wgmma", "launches_ds_wgmma" if name.endswith("ds") else "launches_head_wgmma")
    before = [getattr(wrapper, c) for c in counters]
    args = Regions(2, 6, 10, torch.bfloat16, "cpu", seed=4)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 1|failed"):
        wrapper(*getattr(args, "stem_ds" if name.endswith("ds") else "head"))
    assert not {"dgmsr_stem_ds", "dgmsr_head"} & {fn for _, fn, _ in calls}
    assert [getattr(wrapper, c) for c in counters] == before


# ------------------------------------------------------------ q_sample


@pytest.mark.parametrize("t", [-1, 0, 7])
def test_q_sample_matches_jax_at_every_timestep(t):
    """``q_sample`` against JAX ``GaussianDiffusion.q_sample`` at T = 8:
    t = -1 returns x_start (the schedule is indexed at max(t, 0) and masked),
    t = 0 and T - 1 are the schedule's ends; one batch mixes t and -1."""
    rng = np.random.default_rng(8 + t)
    x_start = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    ts = np.array([t, -1], dtype=np.int32)
    ours = GaussianDiffusion(None, None, make_schedule(timesteps=8)).q_sample(
        torch.from_numpy(x_start), torch.from_numpy(ts).long(), torch.from_numpy(noise))
    ref = JaxDiffusion(None, None, jax_make_schedule(timesteps=8)).q_sample(
        jnp.asarray(x_start), jnp.asarray(ts), jnp.asarray(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours[1].numpy(), x_start[1])
