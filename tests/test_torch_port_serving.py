"""Serving over the HR-pixel budget: the port's tiling ops, sub-batches,
feathered tiles and progress against the JAX package's, on the CPU.

The ops run on the same seeded numpy inputs in both packages (NHWC there,
NCHW here) and must agree exactly: they only move and weight pixels. The
pipelines (hidden 8, RRDB nb 3, T 2, the JAX budget tests' model) get the
same random params through ``ckpt/jax_params.py``; the JAX pipeline runs on
a one-device mesh, so its per-chip budget is the per-call budget. The port
takes the JAX key stream call by call through a ``ChunkNoise``: the call at
chunk path ``(i, ci, ...)`` is fed the draws of ``fold_in(fold_in(key, i),
ci)...``, as the JAX pipeline folds its key for sub-batch ``ci`` and tiled
image ``i``. Both pipelines are spied on, and must make the same calls.
Tolerance: the served one's, 1e-4 absolute on the float [0, 1] output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.ops import image as ji
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch import inference as tinf
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import ChunkNoise, SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.ops import image as ti

from torch_port_helpers import jax_noise, random_jax_params

TINY = dict(compute_dtype="float32", hidden_size=8, rrdb_num_block=3, rrdb_num_feat=8, timesteps=2)
ATOL = 1e-4


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
    return np.transpose(t.numpy(), (0, 2, 3, 1))


# ------------------------------------------------------------------ the ops
@pytest.mark.parametrize("h,w,patch,overlap", [(16, 24, 8, 0), (16, 24, 8, 2), (13, 21, 8, 3), (8, 8, 8, 2)])
def test_tiles_match_jax(h, w, patch, overlap):
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    tj, cj = ji.extract_tiles(jnp.asarray(x), patch, overlap)
    tt, ct = ti.extract_tiles(nchw(x), patch, overlap)
    assert ct == cj
    np.testing.assert_array_equal(nhwc(tt), np.asarray(tj))
    sr = np.random.default_rng(1).standard_normal((len(cj) * 2, 4 * patch, 4 * patch, 3)).astype(np.float32)
    mj = ji.merge_tiles(jnp.asarray(sr), cj, (4 * h, 4 * w), scale=4, overlap=overlap, n=2)
    mt = ti.merge_tiles(nchw(sr), ct, (4 * h, 4 * w), scale=4, overlap=overlap, n=2)
    np.testing.assert_allclose(nhwc(mt), np.asarray(mj), rtol=1e-6, atol=1e-6)
    # tiles cut from one image merge back into it, seams and all
    back = ti.merge_tiles(tt, ct, (h, w), overlap=overlap, n=2)
    np.testing.assert_allclose(nhwc(back), x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [None, 3])
def test_patches_match_jax(stride):
    x = np.random.default_rng(2).standard_normal((2, 12, 16, 3)).astype(np.float32)
    pj, gj = ji.extract_patches(jnp.asarray(x), 4, stride)
    pt, gt = ti.extract_patches(nchw(x), 4, stride)
    assert gt == gj
    np.testing.assert_array_equal(nhwc(pt), np.asarray(pj))
    if stride is None:
        np.testing.assert_array_equal(nhwc(ti.merge_patches(pt, gt, n=2)), np.asarray(ji.merge_patches(pj, gj, n=2)))
        np.testing.assert_array_equal(nhwc(ti.merge_patches(pt, gt, n=2)), x)


def test_img_merger_matches_jax():
    """Two image slots on a 2 x 3 grid, pushed out of order: the port's CHW
    stitch is the JAX HWC stitch transposed."""
    rng = np.random.default_rng(3)
    patches = {(x, y): rng.standard_normal((2, 4, 5, 3)).astype(np.float32) for x in range(2) for y in range(3)}
    mj, mt = ji.ImgMerger(lambda *a: a), ti.ImgMerger(lambda *a: a)
    for loc in [(1, 2), (0, 0), (1, 0), (0, 2), (0, 1), (1, 1)]:
        rj = mj.push(list(patches[loc]), loc, (2, 3))
        rt = mt.push([torch.from_numpy(p.transpose(2, 0, 1).copy()) for p in patches[loc]], loc, (2, 3))
    assert len(rt) == len(rj) == 2
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy().transpose(1, 2, 0), b)
    assert mt.loc2imgs == {}


# -------------------------------------------------------------- pipelines
@pytest.fixture(scope="module")
def params():
    """The params, and one JAX pipeline per sampler: its compiled programs
    (one per LR batch shape, several seconds each here) serve every test;
    the budget and tile settings are read per request, so each test sets
    its own ``hp``."""
    return random_jax_params(JHparams(TINY), 0)[1], {}


def _pipes(params, monkeypatch, **over):
    """(JAX pipeline, port pipeline, calls): the batch sizes each made of
    ``upscale_batch_device``, and the images each sent to ``upscale_large``."""
    params, jax_pipes = params
    cfg = dict(TINY, **over)
    sampler = (cfg.get("sampler"), cfg.get("sample_timesteps"), cfg.get("ddim_eta"))
    if sampler not in jax_pipes:
        jax_pipes[sampler] = JaxPipeline(JHparams(cfg), params=params,
                                         mesh=make_mesh("dp=1", devices=jax.devices()[:1]))
    jpipe = jax_pipes[sampler]
    jpipe.hp = JHparams(cfg)
    tpipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(params), device="cpu")
    calls = {"jax": [], "port": [], "jax_large": [], "port_large": []}

    def spy(cls, name, key, shape):
        orig = getattr(cls, name)

        def wrapped(self, imgs, *a, **k):
            calls[key].append(shape(imgs))
            return orig(self, imgs, *a, **k)
        monkeypatch.setattr(cls, name, wrapped)

    spy(JaxPipeline, "upscale_batch_device", "jax", lambda a: int(np.asarray(a).shape[0]))
    spy(SRDiffPipeline, "upscale_batch_device", "port", lambda a: int(a.shape[0]))
    spy(JaxPipeline, "upscale_large", "jax_large", lambda a: (np.asarray(a).shape, a.dtype.name))
    spy(SRDiffPipeline, "upscale_large_device", "port_large", lambda a: (tuple(a.shape), str(a.dtype)))
    return jpipe, tpipe, calls


def chunk_noise(key, timesteps):
    """The JAX key stream for the port's calls, folded along each call's
    chunk path."""
    def hook(path, shape):
        k = key
        for i in path:
            k = jax.random.fold_in(k, i)
        n, c, h, w = shape
        return jax_noise(k, (n, h, w, c), range(timesteps))
    return ChunkNoise(hook)


def lr_batch(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# (name, budget overrides, LR batch shape, batch sizes of both pipelines' calls)
BUDGET_CASES = [
    # 2 images' worth of 32x32 HR: a batch of 5 in three sub-batches of 2,
    # the last padded with its final image
    ("sub_batches", dict(max_native_hr_pixels=2 * 32 * 32), (5, 8, 8, 3), [5, 2, 2, 2]),
    # the serving point's rule at tiny widths: 8 images a call, a batch of 9
    ("batch_of_9", dict(max_native_hr_pixels=8 * 32 * 32), (9, 8, 8, 3), [9, 8, 8]),
    # one image a call: the per-call budget of one device
    ("one_per_call", dict(max_native_hr_pixels=32 * 32), (2, 7, 7, 3), [2, 1, 1]),
    # budgeted at the padded size: 7x7 pads to 8x8 (1024 HR px, not 784)
    ("padded_dims", dict(max_native_hr_pixels=1800), (2, 7, 7, 3), [2, 1, 1]),
    ("budget_zero", dict(max_native_hr_pixels=0), (2, 8, 8, 3), [2]),
]


@pytest.mark.parametrize("name,over,shape,want", BUDGET_CASES, ids=[c[0] for c in BUDGET_CASES])
def test_budget_matches_jax_chunk_by_chunk(params, monkeypatch, name, over, shape, want):
    jpipe, tpipe, calls = _pipes(params, monkeypatch, **over)
    lr = lr_batch(len(name), shape)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jpipe.upscale_batch_device(lr, rng=key))
    got = tpipe.upscale_batch_device(lr, noise=chunk_noise(key, TINY["timesteps"]))
    assert calls["jax"] == calls["port"] == want
    assert tuple(got.shape) == ref.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_oversized_images_in_a_batch_route_to_tiles(params, monkeypatch):
    """Each image alone over the budget (64x96 HR > 4096 px) goes to the
    feathered tiles, whose 12 tiles are served in three sub-batches of 4."""
    jpipe, tpipe, calls = _pipes(params, monkeypatch, max_native_hr_pixels=4 * 32 * 32, infer_patch_size=8,
                                 infer_patch_overlap=2)
    lr = lr_batch(6, (2, 16, 24, 3))
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jpipe.upscale_batch_device(lr, rng=key))
    got = tpipe.upscale_batch_device(lr, noise=chunk_noise(key, TINY["timesteps"]))
    assert [s for s, _ in calls["jax_large"]] == [s for s, _ in calls["port_large"]] == [(16, 24, 3)] * 2
    assert calls["jax"] == calls["port"] == [2] + [12, 4, 4, 4] * 2
    assert tuple(got.shape) == ref.shape == (2, 64, 96, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # uint8 out of the tiled route: the float result rounded (image 0 alone
    # takes image 0's chunk paths)
    got8 = tpipe.upscale_batch_device(lr[:1], as_uint8=True, noise=chunk_noise(key, TINY["timesteps"]))
    assert got8.dtype == torch.uint8
    assert np.abs(got8.numpy().astype(np.int16) - np.round(ref[:1] * 255.0).astype(np.int16)).max() <= 1


def test_huge_single_image_autoroutes_to_tiles(params, monkeypatch):
    jpipe, tpipe, calls = _pipes(params, monkeypatch, max_native_hr_pixels=4 * 32 * 32, infer_patch_size=8,
                                 infer_patch_overlap=2)
    lr = lr_batch(2, (16, 24, 3))
    key = jax.random.PRNGKey(9)
    ref = jpipe.upscale(lr, rng=key)
    got = tpipe.upscale(lr, noise=chunk_noise(key, TINY["timesteps"]))
    assert len(calls["jax_large"]) == len(calls["port_large"]) == 1
    assert calls["jax"] == calls["port"] == [12, 4, 4, 4]
    assert got.shape == ref.shape == (64, 96, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_small_image_stays_native(params, monkeypatch):
    _, tpipe, calls = _pipes(params, monkeypatch, max_native_hr_pixels=4 * 32 * 32)
    sr = tpipe.upscale(lr_batch(3, (8, 8, 3)))
    assert sr.shape == (32, 32, 3) and np.isfinite(sr).all()
    assert calls["port"] == [1] and calls["port_large"] == []


@pytest.mark.parametrize("overlap,h,w", [(0, 13, 29), (2, 13, 21)])
def test_upscale_large_matches_jax(params, monkeypatch, overlap, h, w):
    """Overlap 0: the hard grid over the image padded to whole tiles
    (13x29 -> 16x32, reflect); overlap 2: feathered seams. Unbudgeted;
    8 tiles either way."""
    jpipe, tpipe, calls = _pipes(params, monkeypatch, max_native_hr_pixels=0)
    lr = np.random.default_rng(4).integers(0, 256, (h, w, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(10)
    ref = jpipe.upscale_large(lr, patch=8, overlap=overlap, rng=key)
    got = tpipe.upscale_large(lr, patch=8, overlap=overlap, noise=chunk_noise(key, TINY["timesteps"]))
    assert calls["jax"] == calls["port"] == [8]
    assert got.shape == ref.shape == (4 * h, 4 * w, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_progress_is_monotone_complete_and_exact(params, monkeypatch, sampler):
    """The progress path over two sub-batches: ``done`` rises to
    ``total`` and never falls, and the segmented sampler gives the whole
    run's result. The ancestral run is held against JAX's progress path
    (callback and output); the DDIM one shares its driver."""
    over = dict(max_native_hr_pixels=2 * 32 * 32, sampler=sampler)
    if sampler == "ddim":
        over.update(sample_timesteps=2, ddim_eta=1.0)
    lr = lr_batch(1, (3, 8, 8, 3))
    key = jax.random.PRNGKey(11)
    tpipe = SRDiffPipeline(Hparams(dict(TINY, **over)), params=jax_params_to_state_dict(params[0]), device="cpu")
    seen = []
    got = tpipe.upscale_batch(lr, noise=chunk_noise(key, TINY["timesteps"]),
                              progress_cb=lambda d, t: seen.append((d, t)))
    assert seen == [(d, 4) for d in range(1, 5)]
    whole = tpipe.upscale_batch(lr, noise=chunk_noise(key, TINY["timesteps"]))
    np.testing.assert_array_equal(got, whole)
    if sampler == "ddpm":
        jpipe, _, _ = _pipes(params, monkeypatch, **over)
        seen_j = []
        ref = jpipe.upscale_batch(lr, rng=key, progress_cb=lambda d, t: seen_j.append((d, t)))
        assert seen_j == seen
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_split_request_needs_chunk_noise_and_derives_generators(params, monkeypatch):
    """A plain hook cannot be split; without one each chunk draws from its
    own generator, seeded from the caller's: the same generator seed gives
    the same result, another seed another."""
    _, tpipe, _ = _pipes(params, monkeypatch, max_native_hr_pixels=32 * 32)
    lr = lr_batch(5, (2, 8, 8, 3))
    with pytest.raises(ValueError, match="ChunkNoise"):
        tpipe.upscale_batch_device(lr, noise=jax_noise(jax.random.PRNGKey(0), (2, 32, 32, 3), range(2)))
    a = tpipe.upscale_batch(lr, generator=torch.Generator().manual_seed(1))
    b = tpipe.upscale_batch(lr, generator=torch.Generator().manual_seed(1))
    c = tpipe.upscale_batch(lr, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_chunk_noise_paths():
    seen = []
    cn = ChunkNoise(lambda path, shape: seen.append((path, shape)) or path)
    assert cn.hook((1, 3, 4, 4)) == ()
    assert cn.fold_in(2).fold_in(5).hook((2, 3, 8, 8)) == (2, 5)
    assert seen == [((), (1, 3, 4, 4)), ((2, 5), (2, 3, 8, 8))]
    noise, gen = tinf._child(cn, None, 3)
    assert gen is None and noise.path == (3,)
