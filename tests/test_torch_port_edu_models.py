"""The educational models' building blocks and modules in the port, held
against the JAX package's on the CPU.

- ``MultiheadAttention`` in every mode ``tests/test_torch_parity.py:327-391``
  covers (bias_kv, zero_attn, additive and boolean masks with padding,
  ``before_softmax``, ``need_head_weights``, ``need_weights=False``), with
  the JAX params carried across by ``ckpt/jax_params.py``;
- ``kernels_disabled`` (every gate off, re-entrant, restored on exit);
- ``synthetic_mnist`` bit-equal and ``to_model_input`` equal;
- each model's forward (AE, VAE, the MLP and DCGAN GANs and the critic, the
  DDPM UNet and its attention) in train and eval mode, and the BatchNorm
  statistics after a train-mode call;
- the RRDB with ``sr_scale=8``.

Params are the JAX init's shapes filled from a numpy seed: kernels scaled
by 1/sqrt(fan_in), biases and norm scales N(0, 0.01) (so a dropped bias
shows). Bounds: float32 forwards within 1e-5 absolute (2e-5 on
the DDPM UNet's output, whose 17 ResnetBlocks and 7 attentions sum in
another order), attention weights 2e-6, BatchNorm statistics 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.data import mnist as jmnist
from dgm_img_super_resolution_tpu.models import autoencoder as jae, ddpm_unet as jdu, gan as jgan
from dgm_img_super_resolution_tpu.models import layers as jlayers
from dgm_img_super_resolution_tpu.models.rrdb import RRDBNet as JaxRRDB
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import (
    jax_module_params_to_state_dict,
    jax_params_to_state_dict,
)
from dgm_img_super_resolution_tpu_torch.data import mnist as tmnist
from dgm_img_super_resolution_tpu_torch.models import autoencoder as tae, ddpm_unet as tdu, gan as tgan
from dgm_img_super_resolution_tpu_torch.models import layers as tlayers
from dgm_img_super_resolution_tpu_torch.models.rrdb import RRDBNet

from torch_port_helpers import jit_quick

FWD_TOL, UNET_TOL, ATTN_W_TOL, STAT_TOL = 1e-5, 2e-5, 2e-6, 1e-6


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def fill(tree, seed, scale=1.0):
    """A param tree of the JAX init's shapes from a numpy seed: kernels
    N(0, scale^2 / fan_in) (fan_in = all but the last axis), every other
    leaf N(0, (0.1 scale)^2), so activations keep their size through the
    layers, as ``torch_port_helpers.random_jax_params``."""
    rng = np.random.default_rng(seed)

    def one(path, v):
        name = str(path[-1].key)
        if name.endswith("kernel") and v.ndim >= 2:
            return (rng.standard_normal(v.shape) * scale / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(v.shape) * 0.1 * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def init_shapes(module, *args, **kw):
    """The variables' shapes of a flax init, by tracing only (cheap next to
    running the init eagerly)."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))


def japply(module, variables, *args, **kw):
    """``module.apply`` compiled once (eager flax dispatches every op)."""
    fn = lambda v, *a: module.apply(v, *a, **kw)  # noqa: E731
    return jit_quick(fn, variables, *args)(variables, *args)


def carried(port, params, stats=None):
    port.load_state_dict(jax_module_params_to_state_dict(port, params, stats), strict=True)
    return port


# --------------------------------------------------------------- attention
def _mha_pair(e, h, seed, **kw):
    jm = jlayers.MultiheadAttention(embed_dim=e, num_heads=h, **kw)
    x = jnp.zeros((1, 3, e))
    params = fill(init_shapes(jm, x)["params"], seed)
    return jm, params, carried(tlayers.MultiheadAttention(e, h, **kw), params)


@pytest.mark.parametrize("bias_kv,zero_attn,masks", [
    (False, False, None), (True, False, None), (False, True, None), (False, False, "additive"),
    (False, False, "bool"), (True, True, "additive"),
])
def test_multihead_attention_matches_jax(bias_kv, zero_attn, masks):
    e, h, b, tq, tk = 16, 4, 2, 5, 7
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, t, e)).astype(np.float32) for t in (tq, tk, tk))
    jm, params, tm = _mha_pair(e, h, 4, add_bias_kv=bias_kv, add_zero_attn=zero_attn)
    jkw, tkw = {}, {}
    if masks:
        kpm = np.zeros((b, tk), np.bool_)
        kpm[:, -2:] = True  # the last two keys are padding (never a whole row)
        am = (rng.standard_normal((tq, tk)) * 0.5).astype(np.float32)
        if masks == "bool":
            am = np.zeros((tq, tk), np.bool_)
            am[0, 1] = am[3, 0] = True
        jkw = dict(attn_mask=jnp.asarray(am), key_padding_mask=jnp.asarray(kpm))
        tkw = dict(attn_mask=torch.from_numpy(am), key_padding_mask=torch.from_numpy(kpm))
    jout, jw = japply(jm, {"params": params}, q, k, v, **jkw)
    tout, tw = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=0, atol=ATTN_W_TOL)


@pytest.mark.parametrize("mode", ["before_softmax", "need_head_weights", "no_weights"])
def test_multihead_attention_return_modes(mode):
    e, h = 8, 2
    x = np.random.default_rng(0).standard_normal((2, 4, e)).astype(np.float32)
    jm, params, tm = _mha_pair(e, h, 5, add_bias_kv=True)
    kw = {"before_softmax": dict(before_softmax=True), "need_head_weights": dict(need_head_weights=True),
          "no_weights": dict(need_weights=False)}[mode]
    ja, jb = japply(jm, {"params": params}, x, **kw)
    ta, tb = tm(torch.from_numpy(x), **kw)
    if mode == "before_softmax":
        assert tuple(ta.shape) == (2, h, 4, 5) and tuple(tb.shape) == (2, 5, h, e // h)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=0, atol=FWD_TOL)
    if mode == "no_weights":
        assert tb is None and jb is None
    else:
        np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb), rtol=0, atol=FWD_TOL)


def test_leaky_relu_matches_jax_and_its_gradient_at_zero():
    x = np.array([-2.0, -0.5, 0.0, 0.5, 3.0], np.float32)
    np.testing.assert_array_equal(tlayers.leaky_relu(torch.from_numpy(x), 0.2).numpy(),
                                  np.asarray(jlayers.leaky_relu(jnp.asarray(x), 0.2)))
    t = torch.zeros(1, requires_grad=True)
    tlayers.leaky_relu(t, 0.2).sum().backward()
    assert float(t.grad) == float(jax.grad(lambda v: jlayers.leaky_relu(v, 0.2))(0.0)) == 1.0


# ------------------------------------------------------------- kernel gates
GATES = {
    "chain_eligible": lambda: tlayers.chain_eligible(64, 64, 64),
    "chain_stem_enabled": tlayers.chain_stem_enabled,
    "chain_ds_enabled": tlayers.chain_ds_enabled,
    "chain_head_enabled": lambda: tlayers.chain_head_enabled(128, 64),
    "tail_eligible": lambda: tlayers.tail_eligible(64, 64, 64),
    "rowpack_eligible": lambda: tlayers.rowpack_eligible(torch.zeros(1, 64, 8, 8), 64, 64),
}


def test_kernels_disabled_turns_every_gate_off_reentrantly(monkeypatch):
    for k, v in {"DGMSR_PALLAS_DS": "1", "DGMSR_PALLAS_HEAD": "1", "DGMSR_PALLAS_CONV": "1"}.items():
        monkeypatch.setenv(k, v)
    assert all(g() for g in GATES.values())
    with tlayers.kernels_disabled():
        assert not any(g() for g in GATES.values())
        with tlayers.kernels_disabled():
            assert not any(g() for g in GATES.values())
        assert not any(g() for g in GATES.values()), "the inner exit must not turn the gates back on"
    assert all(g() for g in GATES.values())
    with pytest.raises(RuntimeError):
        with tlayers.kernels_disabled():
            raise RuntimeError("inside")
    assert all(g() for g in GATES.values())


def test_kernels_disabled_serves_the_plain_versions_bit_equal():
    """A hidden-64 UNet forward under kernels_disabled equals the same
    forward with every region switched off by its own switch."""
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.models.factory import build_unet, init_srdiff_params

    hp = Hparams(hidden_size=64, unet_dim_mults="1|2", rrdb_num_feat=8, rrdb_num_block=2,
                 compute_dtype="float32", use_rrdb=False)
    unet = init_srdiff_params(build_unet(hp), seed=1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 3, 16, 16)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((1, 3, 4, 4)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((1, 3, 16, 16)).astype(np.float32))
    t = torch.tensor([5])
    with torch.no_grad(), tlayers.kernels_disabled():
        got = unet(x, t, cond, up)
    env = {"DGMSR_PALLAS_FUSED": "0", "DGMSR_PALLAS_TAIL": "0"}
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        want = unet(x, t, cond, up)
    assert torch.equal(got, want)


# --------------------------------------------------------------------- data
def test_synthetic_mnist_bit_equal_and_model_input():
    ti, tl = tmnist.synthetic_mnist(48, seed=7)
    ji, jl = jmnist.synthetic_mnist(48, seed=7)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    for size in (28, 32, 64):
        np.testing.assert_array_equal(tmnist.to_model_input(ti, size), jmnist.to_model_input(ji, size))
    ds = tmnist.ArrayDataset(ti, tl)
    assert len(ds) == 48 and ds[3][1] == tl[3]


@pytest.mark.parametrize("ext", ["", ".gz"])
def test_load_mnist_reads_idx(tmp_path, ext):
    import gzip
    import struct

    imgs, labels = tmnist.synthetic_mnist(5, seed=1)
    opener = gzip.open if ext else open
    for name, arr in (("train-images-idx3-ubyte", imgs), ("train-labels-idx1-ubyte", labels)):
        with opener(tmp_path / (name + ext), "wb") as f:
            f.write(struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape))
            f.write(arr.astype(np.uint8).tobytes())
    got_i, got_l = tmnist.load_mnist(str(tmp_path))
    np.testing.assert_array_equal(got_i, imgs)
    np.testing.assert_array_equal(got_l, labels.astype(np.uint8))
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist(str(tmp_path), split="test")


# ------------------------------------------------------------------- models
def test_autoencoder_and_vae_forward_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (3, 32, 32, 1)).astype(np.float32)
    ja = jae.AutoEncoder(latent_dim=2)
    pa = fill(init_shapes(ja, jnp.asarray(x))["params"], 2)
    ta = carried(tae.AutoEncoder(2), pa)
    np.testing.assert_allclose(to_np(ta(nchw(x))), np.asarray(japply(ja, {"params": pa}, x)), rtol=0, atol=FWD_TOL)

    jv = jae.VAE(latent_dim=4)
    key = jax.random.PRNGKey(3)
    pv = fill(init_shapes(jv, jnp.asarray(x), key)["params"], 3)
    tv = carried(tae.VAE(4), pv)
    eps = jax.random.normal(key, (3, 4))  # the draw VAE.reparameterize takes from the key
    jr, jmu, jlv = japply(jv, {"params": pv}, x, key)
    tr, tmu, tlv = tv(nchw(x), eps=torch.from_numpy(np.asarray(eps)))
    for got, want in ((tr, jr), (tmu, jmu), (tlv, jlv)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=FWD_TOL)


def test_autoencoder_at_28_pads_as_flax_same():
    """28 -> 14 -> 7 -> 4: the stride-2 SAME convs pad an odd side on both
    ends and an even side at the high end only."""
    x = np.random.default_rng(4).uniform(0, 1, (2, 28, 28, 1)).astype(np.float32)
    je = jae.ConvEncoder(latent_dim=3)
    p = fill(init_shapes(je, jnp.asarray(x))["params"], 5)
    te = carried(tae.ConvEncoder(3, in_hw=28), p)
    np.testing.assert_allclose(te(nchw(x)).detach().numpy(), np.asarray(japply(je, {"params": p}, x)), rtol=0,
                               atol=FWD_TOL)


def _bn_pair(jm, tm, x_np, seed):
    v = init_shapes(jm, jnp.asarray(x_np), train=True)
    params = fill(v["params"], seed)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32), v["batch_stats"])
    return params, stats, carried(tm, params, stats)


@pytest.mark.parametrize("which", ["dcgan_gen", "dcgan_disc", "critic"])
def test_batchnorm_models_train_and_eval_match_jax(which):
    rng = np.random.default_rng(6)
    if which == "dcgan_gen":
        x = rng.standard_normal((4, 64)).astype(np.float32)
        jm, tm, tx = jgan.DCGANGenerator(), tgan.DCGANGenerator(), torch.from_numpy(x)
    else:
        x = rng.uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
        jm, tm = (jgan.DCGANDiscriminator(), tgan.DCGANDiscriminator()) if which == "dcgan_disc" else \
            (jgan.Critic(), tgan.Critic())
        tx = nchw(x)
    params, stats, tm = _bn_pair(jm, tm, x, 7)
    # eval: the running statistics normalise
    tm.eval()
    want = japply(jm, {"params": params, "batch_stats": stats}, x, train=False)
    np.testing.assert_allclose(to_np(tm(tx)), np.asarray(want), rtol=0, atol=FWD_TOL)
    # train: the batch's statistics normalise and move the running ones (biased variance, momentum 0.99)
    tm.train()
    want, upd = japply(jm, {"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
    got = tm(tx)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=FWD_TOL)
    want_sd = jax_module_params_to_state_dict(tm, params, upd["batch_stats"])
    stat_keys = [k for k in want_sd if "running_" in k]
    assert len(stat_keys) >= 4
    for k in stat_keys:
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), want_sd[k].numpy(), rtol=0, atol=STAT_TOL,
                                   err_msg=k)
    if which == "dcgan_gen":
        assert tuple(got.shape) == (4, 1, 28, 28)


def test_mlp_gan_models_match_jax():
    rng = np.random.default_rng(8)
    z = rng.standard_normal((3, 64)).astype(np.float32)
    jg = jgan.MLPGenerator()
    pg = fill(init_shapes(jg, jnp.asarray(z))["params"], 9)
    tg = carried(tgan.MLPGenerator(), pg)
    img = np.asarray(japply(jg, {"params": pg}, z))
    np.testing.assert_allclose(tg(torch.from_numpy(z)).detach().numpy(), img, rtol=0, atol=FWD_TOL)
    jd = jgan.MLPDiscriminator()
    x = rng.uniform(-1, 1, (3, 28, 28, 1)).astype(np.float32)
    pd = fill(init_shapes(jd, jnp.asarray(x))["params"], 10)
    td = carried(tgan.MLPDiscriminator(), pd)
    # an NCHW image flattens in JAX's NHWC order
    np.testing.assert_allclose(td(nchw(x)).detach().numpy(), np.asarray(japply(jd, {"params": pd}, x)), rtol=0,
                               atol=FWD_TOL)


def test_ddpm_unet_and_attention_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    ju = jdu.DDPMUnet(dim=16)
    p = fill(init_shapes(ju, jnp.asarray(x), jnp.asarray(t))["params"], 12)
    tu = carried(tdu.DDPMUnet(dim=16), p)
    want = np.asarray(japply(ju, {"params": p}, x, t))
    np.testing.assert_allclose(to_np(tu(nchw(x), torch.from_numpy(t).long())), want, rtol=0, atol=UNET_TOL)
    ja = jdu.SelfAttention2D()
    h = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    pa = fill(init_shapes(ja, jnp.asarray(h))["params"], 13)
    ta = carried(tdu.SelfAttention2D(32), pa)
    np.testing.assert_allclose(to_np(ta(nchw(h))), np.asarray(japply(ja, {"params": pa}, h)), rtol=0, atol=FWD_TOL)


def test_rrdb_x8_matches_jax():
    """The x8 head (``upconv3``, JAX ``models/rrdb.py:94``), which no other
    port test builds."""
    rng = np.random.default_rng(14)
    x = rng.uniform(-1, 1, (1, 6, 5, 3)).astype(np.float32)
    jr = JaxRRDB(out_nc=3, nf=8, nb=2, gc=4, sr_scale=8)
    p = fill(init_shapes(jr, jnp.asarray(x))["params"], 15)
    sd = {k.removeprefix("rrdb."): v for k, v in jax_params_to_state_dict({"rrdb": p}).items()}
    tr = RRDBNet(out_nc=3, nf=8, nb=2, gc=4, sr_scale=8)
    tr.load_state_dict(sd, strict=True)
    jout, jfeas = japply(jr, {"params": p}, x, get_fea=True)
    tout, tfeas = tr(nchw(x), True)
    assert tuple(tout.shape) == (1, 3, 48, 40)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), rtol=0, atol=FWD_TOL)
    for got, want in zip(tfeas, jfeas):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=FWD_TOL)
