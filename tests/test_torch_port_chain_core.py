"""The bf16 C = 64 chain's route onto the warpgroup-MMA conv core
(``csrc/block_chain_wgmma.cu``), on the CPU.

The core's route computes the stem regions in pieces: the stem launch writes
(h1, r1) (``stem_h1_plain``), or an h1 pass maps an a_pre made outside the
chain to h1 (``h1_plain``); then three conv launches run the chain from h1
(``chain_from_h1_plain``). Those plain pieces are what ``block_chain3_plain``
and ``block_chain3_stem_plain`` are made of. Here they are held, composed as
the kernels run them, against the regions' plain versions bit for bit in
bf16, and against the JAX package's ``block_chain3_stem_reference`` and
``block_chain3_stem_ds_reference`` in float32 (2e-5 absolute + 2e-5
relative, as ``tests/test_torch_port_regions.py``: float32 sums in another
order over at most 5 chained convs).

The routing itself runs the wrappers' device path on CPU tensors: ``on_cpu``
answers False and a fake C function stands in for each library, so the
tests see which library and function each dtype and width reaches, with how
many arguments, and that a failing launch or library raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ops.pallas.block_chain import (
    block_chain3_stem_ds_reference,
    block_chain3_stem_reference,
)
from dgm_img_super_resolution_tpu_torch.models.layers import reflect_conv3x3
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

from chip_smoke import Regions, chain_inputs

TOL = dict(rtol=2e-5, atol=2e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _hwio(w):
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


def _stem_inputs(rng, b, c, h, w, with_cond, with_ds):
    """numpy (x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc, wd, bd, cond[, wds, bds])."""
    def conv(co, ci, k):
        return (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)).astype(np.float32)

    def vec(n, s=0.2):
        return (rng.standard_normal(n) * s).astype(np.float32)

    args = (rng.standard_normal((b, h, w, 3)).astype(np.float32), conv(c, 3, 3), vec(c), conv(c, 3, 1), vec(c),
            vec((b, c), 0.5), vec((b, c), 0.5), conv(c, c, 3), vec(c), conv(c, c, 3), vec(c), conv(c, c, 3), vec(c),
            rng.standard_normal((b, h, w, c)).astype(np.float32) if with_cond else None)
    return args + ((conv(c, c, 3), vec(c)) if with_ds else ())


def _jax_args(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc_, wd, bd, cond, *ds):
    a = jnp.asarray
    out = (a(x), _hwio(wa), a(ba), a(wr[:, :, 0, 0].T), a(br), a(tv1), a(tv2), _hwio(wb), a(bb), _hwio(wc), a(bc_),
           _hwio(wd), a(bd), None if cond is None else a(cond))
    return out + ((_hwio(ds[0]), a(ds[1])) if ds else ())


def _core_route(x, wa, ba, wr, br, tv1, tv2, wb, bb, wc, bc_, wd, bd, cond):
    """The stem region as the core's route computes it: stem -> (h1, r1),
    then the chain from h1."""
    h1, r1 = bc.stem_h1_plain(x, wa, ba, wr, br, tv1)
    return bc.chain_from_h1_plain(h1, r1, tv2, wb, bb, wc, bc_, wd, bd, cond)


@pytest.mark.parametrize("with_cond", [False, True])
@pytest.mark.parametrize("b,h,w", [(1, 4, 6), (2, 18, 66)])
def test_pieces_compose_the_regions_bit_for_bit_in_bf16(with_cond, b, h, w):
    """stem -> (h1, r1) -> chain, and a_pre -> h1 -> chain, equal the
    regions' plain versions exactly (the Downsample fold: its output too)."""
    r = Regions(b, h, w, torch.bfloat16, "cpu", seed=h * w + b)
    stem = r.stem if with_cond else r.stem[:-1] + (None,)
    assert torch.equal(_core_route(*stem), bc.block_chain3_stem_plain(*stem))
    out, ds = bc.block_chain3_stem_ds_plain(*stem, *r.stem_ds[-2:])
    assert torch.equal(_core_route(*stem), out)
    assert torch.equal(reflect_conv3x3(out, *r.stem_ds[-2:], stride=2), ds)
    a_pre, r1, tv1, tv2, *convs = r.chain
    cond = torch.randn(a_pre.shape, generator=torch.Generator().manual_seed(b)).to(a_pre.dtype) if with_cond else None
    got = bc.chain_from_h1_plain(bc.h1_plain(a_pre, tv1), r1, tv2, *convs, cond)
    assert torch.equal(got, bc.block_chain3_plain(a_pre, r1, tv1, tv2, *convs, cond))
    a_pre, r1 = bc.stem_plain(*stem[:5])
    assert torch.equal(bc.stem_h1_plain(*stem[:5], stem[5])[0], bc.h1_plain(a_pre, stem[5]))


@pytest.mark.parametrize("c,h,w", [(8, 12, 20), (64, 10, 6), (64, 2, 3)])
@pytest.mark.parametrize("with_cond", [False, True])
def test_core_route_matches_jax_stem_reference(c, h, w, with_cond):
    rng = np.random.default_rng(c + h * w + with_cond)
    args = _stem_inputs(rng, 2, c, h, w, with_cond, with_ds=False)
    ref = block_chain3_stem_reference(*_jax_args(*args))
    t = torch.from_numpy
    targs = (_nchw(args[0]),) + tuple(t(a) for a in args[1:13]) + (None if args[13] is None else _nchw(args[13]),)
    np.testing.assert_allclose(_nhwc(_core_route(*targs)), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c,h,w", [(8, 12, 20), (64, 10, 6)])
@pytest.mark.parametrize("with_cond", [False, True])
def test_core_route_matches_jax_stem_ds_reference(c, h, w, with_cond):
    """The Downsample fold on the core's route: the chain from the pieces,
    then the stride-2 reflect conv over its output (block_chain.cu's
    streamed conv on the card)."""
    rng = np.random.default_rng(10 * c + h + w + with_cond)
    args = _stem_inputs(rng, 2, c, h, w, with_cond, with_ds=True)
    ref_out, ref_ds = block_chain3_stem_ds_reference(*_jax_args(*args))
    t = torch.from_numpy
    targs = (_nchw(args[0]),) + tuple(t(a) for a in args[1:13]) + (None if args[13] is None else _nchw(args[13]),)
    out = _core_route(*targs)
    ds = reflect_conv3x3(out, t(args[14]), t(args[15]), stride=2)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(_nhwc(ds), np.asarray(ref_ds), **TOL)


def _fake_libraries(monkeypatch, fail=None):
    """Stand-ins for the C functions: each call is recorded as (library,
    function, arguments) after checking the argument count against the
    declared signature, and returns 0. ``fail``: "library missing" raises
    when the conv core's library is asked for, "launch refused" returns 1
    from its functions."""
    calls = []

    def function(lib, fn, n_ptrs, n_ints, n_floats=0):
        if fail == "library missing" and lib == "block_chain_wgmma":
            raise RuntimeError(f"nvcc {lib}.cu failed")

        def call(*args):
            assert len(args) == 1 + n_ptrs + n_ints + n_floats + 1, (fn, len(args))
            calls.append((lib, fn, args))
            return 1 if fail == "launch refused" and lib == "block_chain_wgmma" else 0
        return call

    monkeypatch.setattr(K, "on_cpu", lambda *t: False)
    monkeypatch.setattr(K, "stream_ptr", lambda: 0)
    monkeypatch.setattr(bc, "function", function)
    return calls


STEM = ("block_chain_wgmma", "dgmsr_stem_h1")
H1 = ("block_chain_wgmma", "dgmsr_h1")
CORE = ("block_chain_wgmma", "dgmsr_chain3_wgmma")
OLD_STEM = ("block_chain", "dgmsr_stem_head")
OLD_CHAIN = ("block_chain", "dgmsr_block_chain3")
DS = ("block_chain", "dgmsr_stem_ds")
HEAD = ("block_chain", "dgmsr_head")
WIDE = ("chain_wide", "dgmsr_chain_wide")

ROUTES = [  # (wrapper, dtype, width, the C functions called in order)
    ("block_chain3_stem", torch.bfloat16, 64, [STEM, CORE]),
    ("block_chain3_stem", torch.float32, 64, [OLD_STEM, OLD_CHAIN]),
    ("block_chain3_stem_ds", torch.bfloat16, 64, [STEM, CORE, DS]),
    ("block_chain3_stem_ds", torch.float32, 64, [OLD_STEM, OLD_CHAIN, DS]),
    ("block_chain3_head", torch.bfloat16, 64, [HEAD, H1, CORE]),
    ("block_chain3_head", torch.float32, 64, [HEAD, OLD_CHAIN]),
    ("block_chain3", torch.bfloat16, 64, [H1, CORE]),
    ("block_chain3", torch.float32, 64, [OLD_CHAIN]),
    ("block_chain3", torch.bfloat16, 32, [OLD_CHAIN]),
    ("block_chain3", torch.float32, 32, [OLD_CHAIN]),
    ("block_chain3", torch.bfloat16, 128, [WIDE]),
    ("block_chain3", torch.float32, 96, [WIDE]),
]


def _args(name, dtype, c):
    if name == "block_chain3":
        return chain_inputs(2, c, 5, 7, dtype, "cpu", seed=c, cond=True)[0]
    r = Regions(2, 6, 10, dtype, "cpu", seed=c)
    return getattr(r, {"block_chain3_stem": "stem", "block_chain3_stem_ds": "stem_ds",
                       "block_chain3_head": "head"}[name])


@pytest.mark.parametrize("name,dtype,c,want", ROUTES)
def test_each_dtype_and_width_reaches_one_chain_kernel(monkeypatch, name, dtype, c, want):
    """bf16 at C = 64 runs the conv core, h1 coming from the stem launch or
    the h1 pass, and counts in ``launches_wgmma``; float32 and C = 32 reach
    ``block_chain.cu``, C >= 96 ``chain_wide.cu``, unchanged. On the core's
    route the chain reads the h1 and r1 the launch before wrote, and conv_c
    writes h2 over h1."""
    calls = _fake_libraries(monkeypatch)
    wrapper = getattr(bc, name)
    before = wrapper.launches, wrapper.launches_wgmma
    with torch.inference_mode():
        out = wrapper(*_args(name, dtype, c))
    assert [(lib, fn) for lib, fn, _ in calls] == want
    core = CORE in want
    assert (wrapper.launches, wrapper.launches_wgmma) == (before[0] + 1, before[1] + core)
    first = out[0] if isinstance(out, tuple) else out
    assert first.dtype == dtype and first.is_contiguous(memory_format=torch.channels_last)
    if core:
        args = {fn: a for _, fn, a in calls}
        chain = args["dgmsr_chain3_wgmma"]
        if "dgmsr_stem_h1" in args:
            assert chain[1:3] == args["dgmsr_stem_h1"][7:9]  # h1, r1
        else:
            assert chain[1] == args["dgmsr_h1"][3]
        assert chain[12] == chain[1]  # h2 over h1
        assert chain[13] == first.data_ptr() and chain[14:18] == (c, *first.shape[:1], *first.shape[2:])


WRAPPERS = ["block_chain3_stem", "block_chain3_stem_ds", "block_chain3_head", "block_chain3"]
PLAINS = ["block_chain3_plain", "block_chain3_stem_plain", "block_chain3_stem_ds_plain", "block_chain3_head_plain",
          "chain_from_h1_plain", "h1_plain", "stem_plain", "stem_h1_plain"]


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("failure", ["launch refused", "library missing"])
def test_the_core_route_raises_rather_than_falling_back(monkeypatch, name, failure):
    """A bf16 C = 64 call whose conv-core library fails to build, or whose
    launch is refused, raises: it never serves through ``block_chain.cu``'s
    chain or a plain version."""
    calls = _fake_libraries(monkeypatch, fail=failure)
    for plain in PLAINS:
        monkeypatch.setattr(bc, plain, lambda *a, _p=plain: pytest.fail(f"fell back to {_p}"))
    wrapper = getattr(bc, name)
    before = wrapper.launches, wrapper.launches_wgmma
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA error 1|failed"):
        wrapper(*_args(name, torch.bfloat16, 64))
    assert OLD_CHAIN not in [(lib, fn) for lib, fn, _ in calls]
    assert (wrapper.launches, wrapper.launches_wgmma) == before

