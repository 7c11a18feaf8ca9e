"""The port's own copy of the native C++ image ops (``native/``) and
``ops/resize.imresize``'s routing to it, on the CPU.

The library builds here with ``g++`` at first use. Its MATLAB bicubic
equals the numpy matrix path (float64 within 1e-12, as the JAX package's
``tests/test_native.py``; uint8 exactly: the same double sums, rounded by
``nearbyint``, half to even as ``np.around``) and the JAX package's native
library (bit for bit: the same source and flags; that library built for the
test by the JAX package's own ``_build`` into a private path). ``use_native``: None
takes the library where it built, False the matrix path, True raises where
the library is missing; ``Measure`` passes its ``use_native`` on.
"""

import numpy as np
import pytest

from dgm_img_super_resolution_tpu import native as jnative
from dgm_img_super_resolution_tpu.ops.resize import imresize as jax_imresize
from dgm_img_super_resolution_tpu_torch import native
from dgm_img_super_resolution_tpu_torch.ops import resize

F64_TOL = 1e-12


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.fail("the port's native library did not build (g++ is on this host)")
    return native


@pytest.mark.parametrize("scale", [0.25, 0.5, 2.0, 1.7, 0.37, 4.0])
def test_native_resize_matches_the_matrix_path(built, scale):
    rng = np.random.default_rng(int(scale * 100))
    f = rng.uniform(0, 1, (37, 53, 3))
    u8 = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    got, want = resize.imresize(f, scale=scale, use_native=True), resize.imresize(f, scale=scale, use_native=False)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
    got, want = resize.imresize(u8, scale=scale, use_native=True), resize.imresize(u8, scale=scale, use_native=False)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def jax_library(tmp_path_factory, monkeypatch):
    """The JAX package's native library, built by its own ``_build`` from
    its own source into a path of this test's: its default build writes
    ``_imageops.so`` in place, and a worker that loads that file while
    another's g++ writes it keeps ``available() == False`` for its life."""
    monkeypatch.setattr(jnative, "_SO", str(tmp_path_factory.mktemp("jax_native") / "_imageops.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    return jnative


def test_native_matches_the_jax_packages_library(built, jax_library):
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build (g++ is on this host)")
    rng = np.random.default_rng(3)
    for img in (rng.uniform(0, 255, (29, 41, 3)), rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)):
        np.testing.assert_array_equal(native.matlab_resize(img, (13, 17)), jnative.matlab_resize(img, (13, 17)))
        np.testing.assert_array_equal(resize.imresize(img, scale=0.25), jax_imresize(img, scale=0.25))


def test_default_routes_to_native_and_2d_input(built, monkeypatch):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (20, 20))
    out = resize.imresize(img, sizes=(10, 15))
    assert out.shape == (10, 15)
    np.testing.assert_array_equal(out, native.matlab_resize(img, (10, 15)))
    np.testing.assert_allclose(out, resize.imresize(img, sizes=(10, 15), use_native=False), rtol=0, atol=F64_TOL)
    calls = []
    monkeypatch.setattr(native, "matlab_resize", lambda *a: calls.append(a) or np.zeros((10, 15)))
    resize.imresize(img, sizes=(10, 15))
    resize.imresize(img, sizes=(10, 15), use_native=False)
    resize.imresize(img, sizes=(10, 15), method="bilinear")  # the library computes the bicubic only
    assert len(calls) == 1


def test_missing_library_falls_back_or_raises(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    img = np.random.default_rng(5).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize.imresize(img, scale=0.5),
                                  resize.imresize(img, scale=0.5, use_native=False))
    with pytest.raises(RuntimeError, match="unavailable"):
        resize.imresize(img, scale=0.5, use_native=True)


def test_u8_pm1_roundtrip(built):
    arr = np.random.default_rng(6).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    f = native.u8_to_pm1(arr)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, arr.astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(native.pm1_to_u8(f), arr)


def test_measure_passes_use_native_on(built):
    from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure

    rng = np.random.default_rng(7)
    sr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    lr = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    hr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    a = Measure(device="cpu", use_native=False).measure(sr, hr, lr, 4)
    b = Measure(device="cpu").measure(sr, hr, lr, 4)
    assert a["lr_psnr"] == b["lr_psnr"] and a["psnr"] == b["psnr"]
    assert np.isfinite(a["lr_psnr"])
