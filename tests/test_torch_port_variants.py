"""The kernel-variant configurations of the SRDiff UNet, on the CPU: the
Downsample fold (row 4, ``DGMSR_PALLAS_DS``), the head-fused chain (row 5,
``DGMSR_PALLAS_HEAD``) and the per-conv conv3x3 (row 6,
``DGMSR_PALLAS_CONV``), the gates that route to them, and the routing at
widths other than 64.

The three configurations:

- default: the JAX package's defaults (stem, chain and tail kernels);
- A: ``DGMSR_PALLAS_DS=1 DGMSR_PALLAS_HEAD=1``;
- B: ``DGMSR_PALLAS_FUSED=0 DGMSR_PALLAS_TAIL=0 DGMSR_PALLAS_CONV=1``.

On CPU tensors the wrappers run their plain versions; here they are held in
float32 against the JAX references (``block_chain3_stem_ds_reference``,
``block_chain3_head_reference``, ``reflect_conv3x3``) and against
``conv3x3_rowpack`` in interpret mode. Tolerances: 2e-5 absolute + 2e-5
relative for one region or conv (float32 sums in another order over at most
5 chained convs of K <= 2304), 1e-5 absolute for one conv against the
Pallas kernel (as the JAX package's own test), 5e-5 + 1e-4 relative for a
whole UNet (up to ~30 convs) and 1e-4 absolute on the served [0, 1] image
(as ``tests/test_torch_port_pipeline.py``, whose reasons hold here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.models.layers import mish as jax_mish
from dgm_img_super_resolution_tpu.models.layers import reflect_conv3x3 as jax_reflect_conv3x3
from dgm_img_super_resolution_tpu.ops.pallas.block_chain import (
    block_chain3_head_reference,
    block_chain3_stem_ds_reference,
)
from dgm_img_super_resolution_tpu.ops.pallas.conv3x3 import conv3x3_rowpack
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.models import layers as L
from dgm_img_super_resolution_tpu_torch.models import unet as unet_mod
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3

from chip_smoke import CONFIGS as SERVE_CONFIGS
from chip_smoke import SWITCHES
from torch_port_helpers import jax_noise, random_jax_params

TOL = dict(rtol=2e-5, atol=2e-5)
UNET_TOL = dict(rtol=1e-4, atol=5e-5)
CONFIGS = dict(SERVE_CONFIGS, conv={"DGMSR_PALLAS_CONV": "1"})  # conv: the defaults plus row 6


@pytest.fixture
def config(monkeypatch):
    """Sets one named configuration's switches, every other switch unset."""
    def set_config(name):
        for k in SWITCHES:
            monkeypatch.delenv(k, raising=False)
        for k, v in CONFIGS[name].items():
            monkeypatch.setenv(k, v)
    return set_config


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _hwio(w):
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


def _conv(rng, co, ci, k):
    return (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)).astype(np.float32)


def _vec(rng, n, s=0.2):
    return (rng.standard_normal(n) * s).astype(np.float32)


def _chain(rng, b, c):
    """tv1, tv2, wb, bb, wc, bc, wd, bd as numpy arrays."""
    return (_vec(rng, (b, c), 0.5), _vec(rng, (b, c), 0.5), _conv(rng, c, c, 3), _vec(rng, c),
            _conv(rng, c, c, 3), _vec(rng, c), _conv(rng, c, c, 3), _vec(rng, c))


def _jax_chain(tv1, tv2, wb, bb, wc, bc, wd, bd):
    a = jnp.asarray
    return a(tv1), a(tv2), _hwio(wb), a(bb), _hwio(wc), a(bc), _hwio(wd), a(bd)


# ------------------------------------------------------------- rows 4 and 5
@pytest.mark.parametrize("c,h,w", [(8, 8, 8), (8, 12, 20), (64, 10, 6)])
@pytest.mark.parametrize("with_cond", [False, True])
def test_block_chain3_stem_ds_matches_jax(c, h, w, with_cond):
    rng = np.random.default_rng(c * 10 + h + w)
    b = 2
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    wa, ba, wr, br = _conv(rng, c, 3, 3), _vec(rng, c), _conv(rng, c, 3, 1), _vec(rng, c)
    chain = _chain(rng, b, c)
    cond = rng.standard_normal((b, h, w, c)).astype(np.float32) if with_cond else None
    wds, bds = _conv(rng, c, c, 3), _vec(rng, c)

    ref_out, ref_ds = block_chain3_stem_ds_reference(
        jnp.asarray(x), _hwio(wa), jnp.asarray(ba), jnp.asarray(wr[:, :, 0, 0].T), jnp.asarray(br),
        *_jax_chain(*chain), None if cond is None else jnp.asarray(cond), _hwio(wds), jnp.asarray(bds),
    )
    t = torch.from_numpy
    out, ds = bc.block_chain3_stem_ds(
        _nchw(x), t(wa), t(ba), t(wr), t(br), *map(t, chain), None if cond is None else _nchw(cond),
        t(wds), t(bds),
    )
    assert tuple(ds.shape) == (b, c, h // 2, w // 2)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(_nhwc(ds), np.asarray(ref_ds), **TOL)


@pytest.mark.parametrize("cs,c,h,w", [(8, 8, 8, 8), (16, 8, 7, 12), (128, 64, 6, 10)])
def test_block_chain3_head_matches_jax(cs, c, h, w):
    rng = np.random.default_rng(cs + c + h * w)
    b = 2
    x, skip = (rng.standard_normal((b, h, w, cs)).astype(np.float32) for _ in range(2))
    wa, ba, wr, br = _conv(rng, c, 2 * cs, 3), _vec(rng, c), _conv(rng, c, 2 * cs, 1), _vec(rng, c)
    chain = _chain(rng, b, c)
    ref = block_chain3_head_reference(
        jnp.asarray(x), jnp.asarray(skip), _hwio(wa), jnp.asarray(ba), jnp.asarray(wr[:, :, 0, 0].T),
        jnp.asarray(br), *_jax_chain(*chain),
    )
    t = torch.from_numpy
    got = bc.block_chain3_head(_nchw(x), _nchw(skip), t(wa), t(ba), t(wr), t(br), *map(t, chain))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_stream_taps_layout():
    """The weight layout of the streaming conv (one (tap, C_out, 64) slab per
    64-channel input slice), checked by emulating its loop with einsums."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 128, 5, 7, generator=g)
    w = torch.randn(64, 128, 3, 3, generator=g)
    taps = bc.stream_taps(w, torch.float32)
    assert tuple(taps.shape) == (2, 9, 64, 64)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect")
    got = 0
    for s in range(2):
        for t in range(9):
            dy, dx = divmod(t, 3)
            got = got + torch.einsum("bchw,oc->bohw", xp[:, 64 * s:64 * (s + 1), dy:dy + 5, dx:dx + 7], taps[s, t])
    torch.testing.assert_close(got, torch.nn.functional.conv2d(xp, w), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------- row 6
@pytest.mark.parametrize("c,h,w", [(8, 5, 11), (32, 8, 8), (64, 6, 9)])
@pytest.mark.parametrize("act", [False, True])
def test_conv3x3_matches_jax_reflect_conv(c, h, w, act):
    rng = np.random.default_rng(c + h + w + act)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    k, b = _conv(rng, c, c, 3), _vec(rng, c)
    ref = jax_reflect_conv3x3(jnp.asarray(x), _hwio(k), jnp.asarray(b))
    ref = jax_mish(ref) if act else ref
    got = k3.conv3x3(_nchw(x), torch.from_numpy(k), torch.from_numpy(b), border="reflect", mish=act)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("border", ["zero", "reflect"])
def test_conv3x3_matches_the_pallas_kernel(c, border):
    """Against ``conv3x3_rowpack`` in interpret mode, as the JAX package's
    ``tests/test_models.py`` runs it, with and without Mish."""
    rng = np.random.default_rng(c + len(border))
    x = rng.standard_normal((2, 16, 24, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    for act in (False, True):
        ref = conv3x3_rowpack(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), mish=act, border=border,
                              block_rows=8, interpret=True)
        got = k3.conv3x3(_nchw(x), w, torch.from_numpy(b), border=border, mish=act)
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_conv3x3_refuses_an_unknown_border():
    x = torch.zeros(1, 32, 4, 4)
    with pytest.raises(ValueError, match="border"):
        k3.conv3x3(x, torch.zeros(32, 32, 3, 3), torch.zeros(32), border="replicate")


# ------------------------------------------------------------------- gates
def test_gates(monkeypatch, config):
    """Counterpart of the JAX package's gate test (``tests/test_unet_fused.py``):
    the same switches, defaults and channel conditions; the TPU tile
    conditions and the backend check are gone."""
    config("default")
    assert L.chain_eligible(512, 512, 64) and L.chain_eligible(256, 256, 64)
    assert L.chain_eligible(504, 500, 64)
    assert L.chain_eligible(512, 100, 64) and L.chain_eligible(30, 512, 64)  # TPU-only floors dropped
    assert not L.chain_eligible(1, 512, 64)  # reflect padding needs H, W >= 2
    assert not L.chain_eligible(256, 256, 128) and not L.chain_eligible(256, 256, 32)
    assert L.chain_stem_enabled() and not L.chain_ds_enabled()
    assert not L.chain_head_enabled(128, 64)
    assert L.tail_eligible(256, 256, 64) and L.tail_eligible(6, 10, 64)
    assert not L.tail_eligible(256, 256, 32)
    x = torch.zeros(1, 64, 8, 8)
    assert not L.rowpack_eligible(x, 64, 64)

    monkeypatch.setenv("DGMSR_CHAIN_C", "64")
    assert L.chain_eligible(256, 256, 64)
    for v in ("64,128", "32"):
        monkeypatch.setenv("DGMSR_CHAIN_C", v)
        with pytest.raises(NotImplementedError, match="C=64"):
            L.chain_eligible(256, 256, 64)
    monkeypatch.delenv("DGMSR_CHAIN_C")
    for v in ("0", "false", ""):
        monkeypatch.setenv("DGMSR_PALLAS_FUSED", v)
        assert not L.chain_eligible(512, 512, 64)
        monkeypatch.setenv("DGMSR_PALLAS_TAIL", v)
        assert not L.tail_eligible(256, 256, 64)
        monkeypatch.setenv("DGMSR_PALLAS_STEM", v)
        assert not L.chain_stem_enabled()

    config("A")
    assert L.chain_ds_enabled()
    assert L.chain_head_enabled(128, 64) and L.chain_head_enabled(64, 64)
    assert not L.chain_head_enabled(96, 64) and not L.chain_head_enabled(192, 64)
    assert not L.chain_head_enabled(128, 32)

    config("B")
    assert L.rowpack_eligible(x, 64, 64) and L.rowpack_eligible(torch.zeros(1, 32, 5, 3), 32, 32)
    assert not L.rowpack_eligible(torch.zeros(1, 16, 8, 8), 16, 16)
    assert not L.rowpack_eligible(x, 128, 64)
    assert not L.rowpack_eligible(torch.zeros(1, 64, 1, 8), 64, 64)


# ----------------------------------------------------------------- routing
WRAPPERS = ("block_chain3_stem", "block_chain3_stem_ds", "block_chain3", "block_chain3_head")


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of every region wrapper, and the channel width each
    was called at; the wrappers still run."""
    calls = {name: [] for name in WRAPPERS + ("tail_fuse", "conv3x3")}

    def spy(name, fn, width):
        def wrapped(*a, **kw):
            calls[name].append(width(*a))
            return fn(*a, **kw)
        return wrapped

    widths = {  # C, from the argument that carries it
        "block_chain3_stem": lambda *a: a[1].shape[0], "block_chain3_stem_ds": lambda *a: a[1].shape[0],
        "block_chain3": lambda *a: a[0].shape[1], "block_chain3_head": lambda *a: a[2].shape[0],
    }
    for name in WRAPPERS:
        monkeypatch.setattr(bc, name, spy(name, getattr(bc, name), widths[name]))
    monkeypatch.setattr(unet_mod, "tail_fuse", spy("tail_fuse", unet_mod.tail_fuse, lambda *a: a[0].shape[1]))
    monkeypatch.setattr(k3, "conv3x3", spy("conv3x3", k3.conv3x3, lambda *a: a[0].shape[1]))
    return calls


def _unet(dim, mults):
    from dgm_img_super_resolution_tpu_torch.models.factory import init_srdiff_params

    u = unet_mod.Unet(dim=dim, dim_mults=mults, cond_dim=4, rrdb_num_block=2).eval()
    init_srdiff_params(u, seed=dim)
    return u


def _forward(u, h=16, w=24):
    g = torch.Generator().manual_seed(0)
    x, cond = torch.randn(2, 3, h, w, generator=g), torch.randn(2, u.dim, h, w, generator=g)
    with torch.no_grad():
        return u(x, torch.tensor([3, 7]), cond, cond_projected=True)


ROUTES = [
    # (dim, mults, config, {wrapper: widths it was called at, in call order})
    (64, (1, 2), "default", {"block_chain3_stem": [64], "block_chain3": [64], "tail_fuse": [64]}),
    (64, (1, 2), "A", {"block_chain3_stem_ds": [64], "block_chain3_head": [64], "tail_fuse": [64]}),
    (64, (1, 2), "B", {"conv3x3": [64] * 7}),
    (64, (1, 2, 3, 4), "B", {"conv3x3": [64] * 7}),
    # C != 64: only the C = 64 stages reach the chain kernel (down stage 1
    # and up stage 1 at dim 32; down stage 3 and the mid blocks at dim 16)
    (32, (1, 2, 3, 4), "default", {"block_chain3": [64, 64]}),
    (32, (1, 2, 3, 4), "A", {"block_chain3": [64, 64]}),
    (32, (1, 2, 3, 4), "conv", {"block_chain3": [64, 64], "conv3x3": [32] * 7}),
    (16, (1, 2, 3, 4), "default", {"block_chain3": [64, 64]}),
    (16, (1, 2, 3, 4), "conv", {"conv3x3": [32, 32, 32, 64, 32, 32, 32], "block_chain3": [64, 64]}),
]


@pytest.mark.parametrize("dim,mults,name,want", ROUTES)
def test_routing(spies, config, dim, mults, name, want):
    """Which wrappers a forward calls, and at which widths, under each
    configuration. Before the routing went through the gates, a dim=32 or
    dim=16 UNet sent down stage 0 and the tail to the C=64 kernels."""
    config(name)
    _forward(_unet(dim, mults))
    got = {k: v for k, v in spies.items() if v}
    assert got == want


# ------------------------------------------------------- UNet and pipeline
MODELS = {
    "dim64": dict(hidden_size=64, unet_dim_mults="1|2"),
    "dim32": dict(hidden_size=32, unet_dim_mults="1|2|3|4"),
    "dim16": dict(hidden_size=16, unet_dim_mults="1|2|3|4"),
}
UNET_CASES = [("dim64", "default"), ("dim64", "A"), ("dim64", "B"),
              ("dim32", "default"), ("dim32", "conv"), ("dim16", "conv")]


@pytest.fixture(scope="module")
def unets():
    """Per model: the JAX UNet's output on fixed inputs, and the port's
    UNet with the same params."""
    out = {}
    for key, cfg in MODELS.items():
        hp = dict(cfg, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, compute_dtype="float32")
        d, params = random_jax_params(JHparams(hp), 5)
        model = build_srdiff(Hparams(hp))
        model.load_state_dict(jax_params_to_state_dict(params), strict=True)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
        cond = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
        t = np.array([3, 7], np.int32)
        ref = d.denoise_fn.apply({"params": params["denoise_fn"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
        out[key] = (model.denoise_fn.eval(), (x, t, cond), np.asarray(ref))
    return out


@pytest.mark.parametrize("model,name", UNET_CASES)
def test_unet_matches_jax_under_each_configuration(unets, config, model, name):
    unet, (x, t, cond), ref = unets[model]
    config(name)
    with torch.no_grad():
        got = unet(_nchw(x), torch.from_numpy(t), _nchw(cond))
    np.testing.assert_allclose(_nhwc(got), ref, **UNET_TOL)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline's ddim4 output at hidden 64 and the port's pipeline
    with the same params, with the JAX noise stream for the hook."""
    cfg = dict(hidden_size=64, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2|3|4",
               compute_dtype="float32", sampler="ddim", sample_timesteps=4, ddim_eta=1.0)
    _, params = random_jax_params(JHparams(cfg), 2)
    jpipe = JaxPipeline(JHparams(cfg), params=params, mesh=make_mesh("", devices=jax.devices()[:1]))
    tpipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(params), device="cpu")
    imgs = np.random.default_rng(8).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    ts, _ = tpipe.model.ddim_timesteps(4)
    noise = jax_noise(key, (2, 32, 40, 3), ts)
    return tpipe, imgs, noise, np.asarray(jpipe.upscale_batch_device(imgs, rng=key))


@pytest.mark.parametrize("name", ["A", "B"])
def test_upscale_batch_device_matches_jax_under_each_configuration(pipelines, spies, config, name):
    """At hidden 64 the regions are reached (the hidden-8 pipeline test
    reaches none): 4 DDIM steps, one forward each."""
    tpipe, imgs, noise, ref = pipelines
    config(name)
    got = tpipe.upscale_batch_device(imgs, noise=noise)
    assert tuple(got.shape) == ref.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    want = {"A": {"block_chain3_stem_ds": 4, "block_chain3_head": 4, "tail_fuse": 4},
            "B": {"conv3x3": 28}}[name]
    assert {k: len(v) for k, v in spies.items() if v} == want
