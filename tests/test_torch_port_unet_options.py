"""The SRDiff UNet's options that are off in the served config, against the
JAX package on the CPU: ``use_attn`` (the mid block's gated
``LinearAttention``) and ``gn_groups`` (Blocks with GroupNorm).

Random JAX params (the gate ``mid_attn_g`` and the norms' scales drawn away
from their init) are carried across by ``ckpt/jax_params.py`` under the
reference checkpoint's names, which JAX's importer takes back unchanged. The
forward takes the modules' tolerance, 5e-5 absolute + 1e-4 relative in
float32. A spy shows the routing: GroupNorm closes every region, the
attention only the mid pair's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ckpt.torch_import import convert_srdiff_state_dict
from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.models import layers as jl
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.models import layers as tl
from dgm_img_super_resolution_tpu_torch.models import unet as unet_mod
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3

from torch_port_helpers import random_jax_params

TINY = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2|3|4",
            compute_dtype="float32")
OPTIONS = {"use_attn": dict(use_attn=True), "gn_groups8": dict(gn_groups=8)}
TOL = dict(rtol=1e-4, atol=5e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unet_option_matches_jax(option):
    cfg = dict(TINY, **OPTIONS[option])
    d, params = random_jax_params(JHparams(cfg), 3)
    model = build_srdiff(Hparams(cfg))
    sd = jax_params_to_state_dict(params)
    # under the reference checkpoint's names: JAX's importer takes them back
    back, unused = convert_srdiff_state_dict({k: v.numpy() for k, v in sd.items()}, strict=True)
    assert not unused
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])  # noqa: E731
    assert flat(back).keys() == flat(params).keys()
    for k, v in flat(params).items():
        np.testing.assert_array_equal(np.asarray(flat(back)[k]), v, err_msg=str(k))
    model.load_state_dict(sd, strict=True)
    if cfg.get("use_attn"):
        assert float(model.denoise_fn.mid_attn.fn.g.detach()) != 0.0
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    ref = jax.jit(lambda x, t, c: d.denoise_fn.apply({"params": params["denoise_fn"]}, x, t, c))(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = model.denoise_fn.eval()(nchw(x), torch.from_numpy(t), nchw(cond))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 7, 24)).astype(np.float32)
    mod = jl.LinearAttention()
    p = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), p)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    att = tl.LinearAttention(24)
    with torch.no_grad():
        att.to_qkv.weight.copy_(torch.from_numpy(np.transpose(p["to_qkv"]["kernel"], (3, 2, 0, 1)).copy()))
        att.to_out.weight.copy_(torch.from_numpy(np.transpose(p["to_out"]["kernel"], (3, 2, 0, 1)).copy()))
        att.to_out.bias.copy_(torch.from_numpy(p["to_out"]["bias"]))
        got = att(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_group_norm_block_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 10, 16)).astype(np.float32)
    mod = jl.Block(32, groups=8)
    p = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    p = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), p)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    blk = tl.Block(16, 32, groups=8)
    assert isinstance(blk.block[2], torch.nn.GroupNorm) and blk.block[2].eps == 1e-6
    with torch.no_grad():
        blk.block[1].weight.copy_(torch.from_numpy(np.transpose(p["conv"]["kernel"], (3, 2, 0, 1)).copy()))
        blk.block[1].bias.copy_(torch.from_numpy(p["conv"]["bias"]))
        blk.block[2].weight.copy_(torch.from_numpy(p["norm"]["scale"]))
        blk.block[2].bias.copy_(torch.from_numpy(p["norm"]["bias"]))
        got = blk(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


@pytest.fixture
def spies(monkeypatch):
    calls = {name: [] for name in ("block_chain3_stem", "block_chain3", "tail_fuse", "conv3x3")}

    def spy(name, fn, width):
        def wrapped(*a, **kw):
            calls[name].append(width(*a))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(bc, "block_chain3_stem", spy("block_chain3_stem", bc.block_chain3_stem,
                                                     lambda *a: a[1].shape[0]))
    monkeypatch.setattr(bc, "block_chain3", spy("block_chain3", bc.block_chain3, lambda *a: a[0].shape[1]))
    monkeypatch.setattr(unet_mod, "tail_fuse", spy("tail_fuse", unet_mod.tail_fuse, lambda *a: a[0].shape[1]))
    monkeypatch.setattr(k3, "conv3x3", spy("conv3x3", k3.conv3x3, lambda *a: a[0].shape[1]))
    return calls


# Hidden 64, mults 1|2, every pair on the chain (DGMSR_CHAIN_C=64,128):
# down stage 0 on the stem region, down stage 1 and the mid pair at 128 and
# the up stage at 64 on the chain, then the tail.
ROUTES = [
    ({}, {"DGMSR_CHAIN_C": "64,128"},
     {"block_chain3_stem": [64], "block_chain3": [128, 128, 64], "tail_fuse": [64]}),
    (dict(use_attn=True), {"DGMSR_CHAIN_C": "64,128"},
     {"block_chain3_stem": [64], "block_chain3": [128, 64], "tail_fuse": [64]}),
    (dict(gn_groups=8), {"DGMSR_CHAIN_C": "64,128"}, {}),
    (dict(gn_groups=8, use_attn=True), {}, {}),
    # the per-conv kernel is not a region: it takes the GroupNorm Blocks' C -> C
    # convs (without Mish), as in JAX
    (dict(gn_groups=8), {"DGMSR_PALLAS_FUSED": "0", "DGMSR_PALLAS_TAIL": "0", "DGMSR_PALLAS_CONV": "1"},
     {"conv3x3": [64] * 7}),
]


@pytest.mark.parametrize("over,env,want", ROUTES)
def test_routing_of_the_options(monkeypatch, spies, over, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    u = unet_mod.Unet(dim=64, dim_mults=(1, 2), cond_dim=4, rrdb_num_block=2,
                      use_attn=over.get("use_attn", False), groups=over.get("gn_groups", 0)).eval()
    init_srdiff_params(u, seed=1)
    g = torch.Generator().manual_seed(0)
    x, cond = torch.randn(2, 3, 16, 24, generator=g), torch.randn(2, 64, 16, 24, generator=g)
    with torch.no_grad():
        out = u(x, torch.tensor([3, 7]), cond, cond_projected=True)
    assert tuple(out.shape) == (2, 3, 16, 24) and torch.isfinite(out).all()
    assert {k: v for k, v in spies.items() if v} == want
