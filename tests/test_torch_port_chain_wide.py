"""The chain region at every width (kernel row 2's wide mode), on the CPU.

Configuration C (``DGMSR_CHAIN_C=64,128,192,256``, ``chip_smoke.CONFIGS``)
routes every ResnetBlock pair of the hidden-64 SRDiff UNet through
``block_chain3``: C = 64 on its resident-weight kernel, 128, 192 and 256 on
the wide kernel of ``csrc/chain_wide.cu``. On CPU tensors the wrapper runs
its plain version; here it is held in float32 against the JAX package's
``block_chain3_reference`` and, at C = 128, against the Pallas kernel
itself in interpret mode (as ``tests/test_block_chain.py`` runs it); the
wide kernel's weight layout is checked by emulating its slice and tap loops
with einsums; and the UNets and a served batch under C are held against the
JAX package. Tolerances: 2e-5 absolute + 2e-5 relative for one region
(float32 sums in another order over 3 chained convs of K <= 2304), 5e-5
against the Pallas kernel (as the JAX package's own test at C = 128), and
for a whole UNet and the served image those of
``tests/test_torch_port_variants.py``, whose reasons hold here.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.ops.pallas.block_chain import block_chain3 as jax_block_chain3
from dgm_img_super_resolution_tpu.ops.pallas.block_chain import block_chain3_reference
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.models import unet as unet_mod
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

from chip_smoke import CONFIGS, SWITCHES
from torch_port_helpers import jax_noise, random_jax_params

TOL = dict(rtol=2e-5, atol=2e-5)
UNET_TOL = dict(rtol=1e-4, atol=5e-5)
HIDDEN128 = {"DGMSR_CHAIN_C": "128,256"}  # the hidden-128 UNet's two stage widths


@pytest.fixture
def switches(monkeypatch):
    """Sets the given kernel switches, every other switch unset."""
    def set_switches(env):
        for k in SWITCHES:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_switches


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _hwio(w):
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


def _chain_inputs(rng, b, h, w, c, with_cond):
    """a_pre, r1, tv1, tv2, wb, bb, wc, bc, wd, bd, cond as float32 numpy
    arrays: activations NHWC, conv weights (C_out, C_in, 3, 3)."""
    def conv():
        return (rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)

    def vec(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    a_pre, r1 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    cond = rng.standard_normal((b, h, w, c)).astype(np.float32) if with_cond else None
    return (a_pre, r1, vec(b, c, s=0.5), vec(b, c, s=0.5), conv(), vec(c), conv(), vec(c), conv(), vec(c), cond)


def _to_jax(a_pre, r1, tv1, tv2, wb, bb, wc, bc_, wd, bd, cond):
    a = jnp.asarray
    return (a(a_pre), a(r1), a(tv1), a(tv2), _hwio(wb), a(bb), _hwio(wc), a(bc_), _hwio(wd), a(bd),
            None if cond is None else a(cond))


def _to_torch(a_pre, r1, tv1, tv2, wb, bb, wc, bc_, wd, bd, cond):
    t = torch.from_numpy
    return (_nchw(a_pre), _nchw(r1), t(tv1), t(tv2), t(wb), t(bb), t(wc), t(bc_), t(wd), t(bd),
            None if cond is None else _nchw(cond))


# ---------------------------------------------------------------- the region
@pytest.mark.parametrize("c,h,w", [(96, 5, 9), (128, 8, 6), (192, 6, 10), (256, 4, 7)])
@pytest.mark.parametrize("with_cond", [False, True])
def test_block_chain3_wide_matches_jax(c, h, w, with_cond):
    rng = np.random.default_rng(c + h * w + with_cond)
    args = _chain_inputs(rng, 2, h, w, c, with_cond)
    ref = block_chain3_reference(*_to_jax(*args))
    counts = bc.block_chain3.launches, dict(bc.block_chain3.launches_by_shape)
    got = bc.block_chain3(*_to_torch(*args))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
    assert (bc.block_chain3.launches, bc.block_chain3.launches_by_shape) == counts  # the plain version launched nothing


@pytest.mark.parametrize("with_cond", [False, True])
def test_block_chain3_c128_matches_the_pallas_kernel(with_cond):
    """Against ``block_chain3`` of the JAX package in interpret mode, its
    unpacked (9, C, C) mode: 4-row blocks over H = 8."""
    rng = np.random.default_rng(128 + with_cond)
    args = _chain_inputs(rng, 1, 8, 16, 128, with_cond)
    ref = jax_block_chain3(*_to_jax(*args), 4, True)
    got = bc.block_chain3(*_to_torch(*args))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("c", [96, 128])
def test_wide_kernel_weight_layout(c):
    """The wide kernel's loops: for each 32-channel input slice k, each tap
    (dy, dx) and each N slice of 64 output channels (32 at C = 96), the
    product of the staged halo pixels with the slab ``taps[k, tap, n0:n0 +
    NB]``, summed; against ``F.conv2d`` on the reflect-padded input."""
    g = torch.Generator().manual_seed(c)
    h, w = 5, 7
    x = torch.randn(2, c, h, w, generator=g)
    wt = torch.randn(c, c, 3, 3, generator=g)
    taps = bc.stream_taps(wt, torch.float32, 32)
    assert tuple(taps.shape) == (c // 32, 9, c, 32)
    nb = 64 if c % 64 == 0 else 32
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    got = torch.zeros(2, c, h, w)
    for n0 in range(0, c, nb):
        for k in range(c // 32):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                got[:, n0:n0 + nb] += torch.einsum(
                    "bchw,oc->bohw", xp[:, 32 * k:32 * (k + 1), dy:dy + h, dx:dx + w], taps[k, tap, n0:n0 + nb])
    torch.testing.assert_close(got, F.conv2d(xp, wt), rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------- routing
@pytest.fixture
def calls(monkeypatch):
    """The widths each region wrapper is called at, in call order; the
    wrappers still run."""
    seen = {"block_chain3_stem": [], "block_chain3": [], "tail_fuse": []}

    def spy(name, fn, width):
        def wrapped(*a, **kw):
            seen[name].append(width(*a))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(bc, "block_chain3_stem", spy("block_chain3_stem", bc.block_chain3_stem,
                                                     lambda *a: a[1].shape[0]))
    monkeypatch.setattr(bc, "block_chain3", spy("block_chain3", bc.block_chain3, lambda *a: a[0].shape[1]))
    monkeypatch.setattr(unet_mod, "tail_fuse", spy("tail_fuse", unet_mod.tail_fuse, lambda *a: a[0].shape[1]))
    return seen


ROUTES = [
    # (dim, mults, switches, {wrapper: widths it was called at, in call order})
    (64, (1, 2, 3, 4), CONFIGS["C"],  # down 1-3, mid, up 0-2
     {"block_chain3_stem": [64], "block_chain3": [128, 192, 256, 256, 192, 128, 64], "tail_fuse": [64]}),
    # down stage 0 fails the stem gate (dim_out != 64): the cuDNN head, then the chain
    (128, (1, 2), HIDDEN128, {"block_chain3": [128, 256, 256, 128]}),
    (32, (1, 2, 3, 4), {"DGMSR_CHAIN_C": "32,64,96,128"}, {"block_chain3": [32, 64, 96, 128, 128, 96, 64, 32]}),
]


@pytest.mark.parametrize("dim,mults,env,want", ROUTES)
def test_routing_at_every_width(calls, switches, dim, mults, env, want):
    switches(env)
    u = unet_mod.Unet(dim=dim, dim_mults=mults, cond_dim=4, rrdb_num_block=2).eval()
    init_srdiff_params(u, seed=dim)
    g = torch.Generator().manual_seed(0)
    x, cond = torch.randn(2, 3, 16, 24, generator=g), torch.randn(2, dim, 16, 24, generator=g)
    with torch.no_grad():
        out = u(x, torch.tensor([3, 7]), cond, cond_projected=True)
    assert tuple(out.shape) == (2, 3, 16, 24)
    assert {k: v for k, v in calls.items() if v} == want


# ------------------------------------------------------- UNet and pipeline
BASE = dict(rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, compute_dtype="float32", sampler="ddim",
            sample_timesteps=4, ddim_eta=1.0)
MODELS = {
    "dim64": (dict(BASE, hidden_size=64, unet_dim_mults="1|2|3|4"), CONFIGS["C"]),
    "dim128": (dict(BASE, hidden_size=128, unet_dim_mults="1|2"), HIDDEN128),
}


@pytest.fixture(scope="module")
def jax_models():
    """Per model: the JAX SRDiff and its random params."""
    return {name: random_jax_params(JHparams(hp), 6) for name, (hp, _) in MODELS.items()}


@pytest.mark.parametrize("model", list(MODELS))
def test_unet_matches_jax_with_every_pair_chained(jax_models, switches, model):
    hp, env = MODELS[model]
    d, params = jax_models[model]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    ref = jax.jit(d.denoise_fn.apply)({"params": params["denoise_fn"]}, x, t, cond)
    model_t = build_srdiff(Hparams(hp))
    model_t.load_state_dict(jax_params_to_state_dict(params), strict=True)
    switches(env)
    with torch.no_grad():
        got = model_t.denoise_fn.eval()(_nchw(x), torch.from_numpy(t), _nchw(cond))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **UNET_TOL)


def test_upscale_batch_device_matches_jax_under_c(jax_models, calls, switches):
    """A hidden-64 ddim4 serve under C: 4 UNet forwards, each with one stem,
    seven chain and one tail call."""
    cfg = MODELS["dim64"][0]
    params = jax_models["dim64"][1]
    jpipe = JaxPipeline(JHparams(cfg), params=params, mesh=make_mesh("", devices=jax.devices()[:1]))
    imgs = np.random.default_rng(9).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jpipe.upscale_batch_device(imgs, rng=key))
    tpipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(params), device="cpu")
    ts, _ = tpipe.model.ddim_timesteps(4)
    switches(CONFIGS["C"])
    got = tpipe.upscale_batch_device(imgs, noise=jax_noise(key, (2, 32, 40, 3), ts))
    assert tuple(got.shape) == ref.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    assert {k: len(v) for k, v in calls.items()} == {"block_chain3_stem": 4, "block_chain3": 28, "tail_fuse": 4}
