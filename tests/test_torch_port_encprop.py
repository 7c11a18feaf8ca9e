"""Encoder propagation in the port's SRDiff sampler, and the samplers' DDIM /
ancestral identity, against the JAX package on the CPU.

- ``mode="encode"`` then ``mode="decode"`` is the full forward bit for bit,
  at tiny widths and at hidden 64 where the regions' plain versions run
  (default and configuration A), and each half matches JAX's.
- ``ddim_sample`` with ``enc_interval`` 2 and 3 over 5 steps (groups, then
  the remainder run exactly) matches JAX's pipeline with the same params
  and the JAX noise stream (a two-stage UNet, which JAX compiles faster),
  at the served tolerance, 1e-4 on the float [0, 1] output, and differs
  from the exact chain (``enc_interval`` 1, held against JAX by
  ``tests/test_torch_port_pipeline.py``).
- Which region wrappers the encodes and the decodes call.
- DDIM with eta 1 over all T steps is the ancestral chain (res and non-res
  regimes), with one noise stream keyed by timestep; 2e-4, as in JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.models import unet as unet_mod
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

from torch_port_helpers import jax_noise, random_jax_params

BASE = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2|3|4",
            compute_dtype="float32")
DDIM5 = dict(sampler="ddim", sample_timesteps=5, ddim_eta=1.0)
CONFIGS = {"default": {}, "A": {"DGMSR_PALLAS_DS": "1", "DGMSR_PALLAS_HEAD": "1"}}
REGIONS = ("block_chain3_stem", "block_chain3_stem_ds", "block_chain3", "block_chain3_head")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.fixture(scope="module")
def tiny():
    d, params = random_jax_params(JHparams(BASE), 1)
    model = build_srdiff(Hparams(BASE))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return d, params, model.eval()


def _inputs(c_cond, h=16, w=24, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    cond = rng.standard_normal((2, h, w, c_cond)).astype(np.float32)
    return x, cond, np.array([3, 7], np.int32)


def test_encode_decode_match_jax_and_compose_to_full(tiny):
    d, params, model = tiny
    x, cond, t = _inputs(8)
    p = {"params": params["denoise_fn"]}
    unet = model.denoise_fn
    with torch.no_grad():
        skips, bott = unet(nchw(x), torch.from_numpy(t), nchw(cond), cond_projected=True, up_folded=True,
                           mode="encode")
        eps = unet(None, torch.from_numpy(t), None, mode="decode", enc_feats=(skips, bott))
        full = unet(nchw(x), torch.from_numpy(t), nchw(cond), cond_projected=True, up_folded=True)
    torch.testing.assert_close(eps, full, rtol=0, atol=0)
    enc_j = jax.jit(lambda x, t, c: d.denoise_fn.apply(p, x, t, c, None, cond_projected=True, up_folded=True,
                                                       mode="encode"))(jnp.asarray(x), jnp.asarray(t),
                                                                       jnp.asarray(cond))
    assert len(skips) == len(enc_j[0]) == 4
    for a, b in zip(skips + (bott,), tuple(enc_j[0]) + (enc_j[1],)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=1e-4, atol=5e-5)
    # JAX's decode on the port's features is the port's decode
    dec_j = jax.jit(lambda t, s, b: d.denoise_fn.apply(p, None, t, None, None, mode="decode", enc_feats=(s, b)))
    eps_j = dec_j(jnp.asarray(t), tuple(jnp.asarray(nhwc(s)) for s in skips), jnp.asarray(nhwc(bott)))
    np.testing.assert_allclose(nhwc(eps), np.asarray(eps_j), rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encode_decode_is_the_full_forward_through_the_regions(monkeypatch, config):
    """Hidden 64, mults 1|2: down stage 0 and up stage 0 reach the regions
    (their plain versions on the CPU); the split runs the same operations."""
    for k, v in CONFIGS[config].items():
        monkeypatch.setenv(k, v)
    u = unet_mod.Unet(dim=64, dim_mults=(1, 2), cond_dim=4, rrdb_num_block=2).eval()
    init_srdiff_params(u, seed=3)
    g = torch.Generator().manual_seed(0)
    x, cond, t = torch.randn(2, 3, 16, 24, generator=g), torch.randn(2, 64, 16, 24, generator=g), torch.tensor([3, 7])
    with torch.no_grad():
        full = u(x, t, cond, cond_projected=True)
        enc = u(x, t, cond, cond_projected=True, mode="encode")
        split = u(None, t, None, mode="decode", enc_feats=enc)
    torch.testing.assert_close(split, full, rtol=0, atol=0)


@pytest.fixture(scope="module")
def two_stage():
    return random_jax_params(JHparams(dict(BASE, unet_dim_mults="1|2")), 2)[1]


@pytest.mark.parametrize("k", [2, 3])
def test_ddim_encoder_propagation_matches_jax(two_stage, k):
    params = two_stage
    cfg = dict(BASE, unet_dim_mults="1|2", enc_interval=k, **DDIM5)
    jpipe = JaxPipeline(JHparams(cfg), params=params, mesh=make_mesh("", devices=jax.devices()[:1]))
    tpipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(params), device="cpu")
    imgs = np.random.default_rng(6).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    ts, _ = tpipe.model.ddim_timesteps(5)
    noise = jax_noise(key, (2, 28, 36, 3), ts)  # 7x9 needs no pad at 2 stages
    ref = np.asarray(jpipe.upscale_batch_device(imgs, rng=key))
    got = tpipe.upscale_batch_device(imgs, noise=noise)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    tpipe.hp = Hparams(dict(cfg, enc_interval=1))
    exact = tpipe.upscale_batch_device(imgs, noise=noise)
    assert 0 < (got - exact).abs().max() < 0.5  # the reuse approximates the exact chain


@pytest.fixture
def spies(monkeypatch):
    calls = {name: 0 for name in REGIONS + ("tail_fuse",)}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in REGIONS:
        monkeypatch.setattr(bc, name, spy(name, getattr(bc, name)))
    monkeypatch.setattr(unet_mod, "tail_fuse", spy("tail_fuse", unet_mod.tail_fuse))
    return calls


# 4 DDIM steps: K = 2 is 2 groups; K = 3 one group and one exact step. The
# encodes run down stage 0's region, the decodes the last up stage's and
# the tail.
ROUTES = [
    ("default", 2, {"block_chain3_stem": 2, "block_chain3": 4, "tail_fuse": 4}),
    ("default", 3, {"block_chain3_stem": 2, "block_chain3": 4, "tail_fuse": 4}),
    ("A", 2, {"block_chain3_stem_ds": 2, "block_chain3_head": 4, "tail_fuse": 4}),
]


@pytest.mark.parametrize("config,k,want", ROUTES)
def test_encoder_propagation_routing(monkeypatch, spies, config, k, want):
    for name, v in CONFIGS[config].items():
        monkeypatch.setenv(name, v)
    hp = Hparams(hidden_size=64, unet_dim_mults="1|2", rrdb_num_block=2, rrdb_num_feat=8, timesteps=8,
                 compute_dtype="float32", sampler="ddim", sample_timesteps=4, ddim_eta=1.0, enc_interval=k)
    pipe = SRDiffPipeline(hp, device="cpu")
    out = pipe.upscale_batch_device(np.zeros((1, 4, 6, 3), np.uint8))
    assert tuple(out.shape) == (1, 16, 24, 3)
    assert {n: c for n, c in spies.items() if c} == want


@pytest.mark.parametrize("res", [True, False])
def test_ddim_eta1_full_T_is_the_ancestral_chain(res):
    """DDIM eta 1 over every timestep: sigma^2 is the posterior variance and
    the means coincide through the recomputed eps, so with the same noise
    of each timestep the two samplers agree to float32 rounding."""
    hp = Hparams(dict(BASE, res=res))
    model = build_srdiff(hp).eval()
    init_srdiff_params(model, seed=2)
    g = torch.Generator().manual_seed(5)
    lr = torch.rand(1, 3, 4, 4, generator=g) * 2 - 1
    lr_up = torch.rand(1, 3, 16, 16, generator=g) * 2 - 1
    noise = (torch.randn(1, 3, 16, 16, generator=g),
             {t: torch.randn(1, 3, 16, 16, generator=g) for t in range(model.num_timesteps)})
    with torch.no_grad():
        anc, _ = model.sample(lr, lr_up, noise=noise)
        ddim, _ = model.ddim_sample(lr, lr_up, num_steps=model.num_timesteps, eta=1.0, noise=noise)
    torch.testing.assert_close(ddim, anc, rtol=0, atol=2e-4)
