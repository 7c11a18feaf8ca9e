"""The port's resizes and metrics against the JAX package's, on the CPU.

- ``ops/resize.py``: every variant's matrix (float64, 1e-12), ``resize``
  on tensors (float32, 1e-5), ``imresize`` (uint8 exactly, float 1e-12);
- ``metrics/psnr_ssim.py``: ``psnr`` (1e-5 relative), the gaussian
  ``ssim`` and ``SSIM`` (1e-5) and the gradient of ``ssim`` against
  ``jax.grad`` (1e-4 of its largest entry), ``ssim_eval`` (1e-5);
- LPIPS and VGG19 on seeded JAX params carried across, through every
  weight file each takes (1e-5 / 1e-4 relative), and the strictness of
  ``convert_lpips_state_dict``;
- ``Measure.measure`` (1e-4; lpips ``nan`` on both sides without weights).
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.ckpt import torch_import as jti
from dgm_img_super_resolution_tpu.metrics import lpips as jlp
from dgm_img_super_resolution_tpu.metrics import perceptual as jpc
from dgm_img_super_resolution_tpu.metrics import psnr_ssim as jps
from dgm_img_super_resolution_tpu.metrics.measure import Measure as JMeasure
from dgm_img_super_resolution_tpu_torch.ckpt import torch_import as tti
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_conv_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.metrics import lpips as tlp
from dgm_img_super_resolution_tpu_torch.metrics import perceptual as tpc
from dgm_img_super_resolution_tpu_torch.metrics import psnr_ssim as tps
from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure
from dgm_img_super_resolution_tpu_torch.ops import resize as trs

jrs = importlib.import_module("dgm_img_super_resolution_tpu.ops.resize")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("variant", ["matlab", "torch", "torch_half", "pil"])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("lens", [(64, 256), (256, 64), (100, 37), (37, 100), (17, 17)])
def test_resize_matrix_matches_jax(variant, method, lens):
    got = trs.resize_matrix(*lens, variant, method, dtype="float64")
    want = jrs.resize_matrix(*lens, variant, method, dtype="float64")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", ["matlab", "torch", "torch_half", "pil"])
def test_resize_on_tensors_matches_jax(variant):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 20, 12, 3)).astype(np.float32)
    for out_hw in ((5, 3), (80, 48), (33, 7)):
        want = np.asarray(jrs.resize(jnp.asarray(x), out_hw, variant=variant))
        got = trs.resize(nchw(x), out_hw, variant=variant).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown resize variant"):
        trs.resize_matrix(8, 4, "lanczos")


@pytest.mark.parametrize("shape,kw", [((48, 40, 3), {"scale": 0.25}), ((30, 22, 3), {"scale": 1 / 3}),
                                      ((16, 12), {"scale": 4.0}), ((21, 13, 3), {"sizes": (10, 15)})])
def test_imresize_matches_jax(shape, kw):
    g = np.random.default_rng(2)
    u8 = g.integers(0, 256, shape, dtype=np.uint8)
    got, want = trs.imresize(u8, **kw), jrs.imresize(u8, use_native=False, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    f = g.uniform(0, 1, shape)
    got, want = trs.imresize(f, **kw), jrs.imresize(f, use_native=False, **kw)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        trs.imresize(u8)


def test_psnr_and_ssim_eval_match_jax():
    g = np.random.default_rng(3)
    for shape in ((40, 36, 3), (23, 31)):
        a = g.integers(0, 256, shape, dtype=np.uint8)
        b = np.clip(a.astype(int) + g.integers(-20, 21, shape), 0, 255).astype(np.uint8)
        want = float(jps.psnr(a.astype(np.float32), b.astype(np.float32), 255.0))
        np.testing.assert_allclose(float(tps.psnr(a.astype(np.float32), b.astype(np.float32))), want, rtol=1e-5)
        np.testing.assert_allclose(tps.ssim_eval(a, b), jps.ssim_eval(a, b), rtol=0, atol=1e-5)
        af, bf = a / 255.0, b / 255.0
        np.testing.assert_allclose(tps.ssim_eval(torch.from_numpy(af), torch.from_numpy(bf), data_range=1.0),
                                   jps.ssim_eval(af, bf, data_range=1.0), rtol=0, atol=1e-5)


def test_gaussian_ssim_loss_and_gradient_match_jax():
    g = np.random.default_rng(4)
    x = g.uniform(-1, 1, (2, 24, 20, 3)).astype(np.float32)
    y = np.clip(x + 0.2 * g.standard_normal(x.shape), -1, 1).astype(np.float32)
    want = float(jps.ssim(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(tps.ssim(nchw(x), nchw(y))), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tps.SSIM()(nchw(x), nchw(y))), float(jps.SSIM()(x, y)), rtol=0, atol=1e-5)
    per = np.asarray(jps.ssim(jnp.asarray(x), jnp.asarray(y), window_size=7, size_average=False))
    np.testing.assert_allclose(tps.ssim(nchw(x), nchw(y), window_size=7, size_average=False).numpy(), per,
                               rtol=0, atol=1e-5)
    gj = np.asarray(jax.grad(lambda a: jps.ssim(a, jnp.asarray(y)))(jnp.asarray(x)))
    xt = nchw(x).requires_grad_(True)
    tps.ssim(xt, nchw(y)).backward()
    gt = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * np.abs(gj).max())


def _fill(shapes, seed):
    """Seeded numpy weights for a Flax param tree of shapes: kernels
    N(0, 1/fan_in), biases N(0, 0.1) (an init's zero biases would hide a
    dropped bias)."""
    g = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v)
            elif k == "bias":
                out[k] = (0.1 * g.standard_normal(v.shape)).astype(np.float32)
            else:
                out[k] = (g.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        return out

    return fill(shapes)


@pytest.fixture(scope="module")
def lpips_params():
    return _fill(jax.eval_shape(lambda: jlp.LPIPS.init_params(jax.random.PRNGKey(0))), 5)


def _lpips_torch_layout(params):
    """The same weights in the torch ``lpips`` package's layout."""
    p = params["params"]
    sd = {"scaling_layer.shift": torch.tensor(jti._LPIPS_SHIFT).view(1, 3, 1, 1),
          "scaling_layer.scale": torch.tensor(jti._LPIPS_SCALE).view(1, 3, 1, 1)}
    for sl, (idx, conv) in jti._LPIPS_SLICES.items():
        sd[f"net.{sl}.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(p["alex"][conv]["kernel"],
                                                                                          (3, 2, 0, 1))))
        sd[f"net.{sl}.{idx}.bias"] = torch.from_numpy(p["alex"][conv]["bias"])
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(p[f"lin{i}"]["kernel"],
                                                                                          (3, 2, 0, 1))))
    return sd


def test_lpips_matches_jax_through_every_weight_file(lpips_params, tmp_path):
    g = np.random.default_rng(6)
    a = g.integers(0, 256, (64, 72, 3), dtype=np.uint8)
    b = g.integers(0, 256, (64, 72, 3), dtype=np.uint8)
    want = jlp.LPIPS(jax.tree_util.tree_map(jnp.asarray, lpips_params))(a, b)
    got = tlp.LPIPS(jax_conv_params_to_state_dict(lpips_params), device="cpu")(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    af = a.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_allclose(tlp.LPIPS(jax_conv_params_to_state_dict(lpips_params), "cpu")(af, b), want,
                               rtol=1e-5)
    npz = tmp_path / "lpips.npz"
    np.savez(npz, **_flat(lpips_params))
    pt = tmp_path / "lpips.pth"
    torch.save(_lpips_torch_layout(lpips_params), pt)
    for path in (npz, pt):
        j, t = jlp.LPIPS.maybe_create(str(path)), tlp.LPIPS.maybe_create(str(path), device="cpu")
        np.testing.assert_allclose(t(a, b), j(a, b), rtol=1e-5)
        np.testing.assert_allclose(t(a, b), want, rtol=1e-5)
    assert tlp.LPIPS.maybe_create(None) is None and tlp.LPIPS.maybe_create(str(tmp_path / "none.npz")) is None


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def test_convert_lpips_state_dict_strictness(lpips_params):
    good = _lpips_torch_layout(lpips_params)
    assert set(tti.convert_lpips_state_dict(good)) == set(tlp._LPIPSNet().state_dict())
    bad_cases = {
        "index": {**{k: v for k, v in good.items() if k != "net.slice2.3.weight"},
                  "net.slice2.4.weight": good["net.slice2.3.weight"]},
        "slice": {**good, "net.slice6.0.weight": good["net.slice1.0.weight"]},
        "shift": {**good, "scaling_layer.shift": good["scaling_layer.shift"] + 0.01},
        "unknown": {**good, "extra.weight": torch.zeros(1)},
        "missing": {k: v for k, v in good.items() if k != "lin3.model.1.weight"},
    }
    for name, sd in bad_cases.items():
        with pytest.raises(ValueError):
            jti.convert_lpips_state_dict(sd)
        with pytest.raises(ValueError):
            tti.convert_lpips_state_dict(sd)
    # not strict: the unknown key is left out, on both sides
    tti.convert_lpips_state_dict(bad_cases["unknown"], strict=False)
    jti.convert_lpips_state_dict(bad_cases["unknown"], strict=False)


def test_vgg19_perceptual_loss_matches_jax(tmp_path):
    net = jpc.VGG19Features()
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = _fill(shapes, 7)
    g = np.random.default_rng(8)
    hr = g.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    fake = np.clip(hr + 0.3 * g.standard_normal(hr.shape), -1, 1).astype(np.float32)
    jloss = jpc.PerceptualLoss(jax.tree_util.tree_map(jnp.asarray, params))
    feats = jax.jit(net.apply)
    fa, fb = feats(jloss.params, jnp.asarray(hr)), feats(jloss.params, jnp.asarray(fake))
    want = float(jnp.abs(fa - fb).mean())  # jpc.PerceptualLoss.__call__, compiled once
    want_feat = np.asarray(fa)
    tloss = tpc.PerceptualLoss(jax_conv_params_to_state_dict(params))
    with torch.no_grad():
        np.testing.assert_allclose(float(tloss(nchw(hr), nchw(fake))), want, rtol=1e-4)
        feat = tloss.net(nchw(hr)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(feat, want_feat, rtol=1e-4, atol=1e-4 * np.abs(want_feat).max())
    # a torchvision vgg19 state dict, mapped by name (the classifier is ignored)
    tv = {f"features.{k[len('conv_'):]}.{'weight' if leaf == 'kernel' else 'bias'}":
          torch.from_numpy(np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)) if leaf == "kernel" else v))
          for k, d in params["params"].items() for leaf, v in d.items()}
    tv["classifier.0.weight"] = torch.zeros(4, 4)
    jtv = jpc.PerceptualLoss.from_torch_vgg19(tv)
    ttv = tpc.PerceptualLoss.from_torch_vgg19(tv)
    jtv_loss = float(jnp.abs(feats(jtv.params, jnp.asarray(hr)) - feats(jtv.params, jnp.asarray(fake))).mean())
    with torch.no_grad():
        np.testing.assert_allclose(float(ttv(nchw(hr), nchw(fake))), jtv_loss, rtol=1e-4)
    npz = tmp_path / "vgg.npz"
    np.savez(npz, **_flat(params))
    with torch.no_grad():
        np.testing.assert_allclose(float(tpc.PerceptualLoss.maybe_create(str(npz))(nchw(hr), nchw(fake))), want,
                                   rtol=1e-4)
    assert tpc.PerceptualLoss.maybe_create(None) is None


def test_measure_matches_jax():
    g = np.random.default_rng(9)
    hr = g.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    lr = jrs.imresize(hr, scale=0.25, use_native=False)
    sr = np.clip(hr.astype(int) + g.integers(-30, 31, hr.shape), 0, 255).astype(np.uint8)
    sr_pm1 = sr.astype(np.float32) / 127.5 - 1.0
    for a in (sr, sr_pm1):
        want = JMeasure().measure(a, hr, lr, 4)
        got = Measure(device="cpu").measure(a, hr, lr, 4)
        assert set(got) == set(want) == {"psnr", "ssim", "lpips", "lr_psnr"}
        assert np.isnan(got["lpips"]) and np.isnan(want["lpips"])
        for k in ("psnr", "ssim", "lr_psnr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
