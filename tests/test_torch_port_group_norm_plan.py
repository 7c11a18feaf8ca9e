"""Kernel row 8's plan and reduction order (``ops/kernels/group_norm.py``,
``csrc/group_norm.cu``), on the CPU.

The CUDA kernel runs persistent thread-block clusters, each taking one item
at a time (a group; in channels_last a block of consecutive groups); CTA r
takes the units [r * slice, (r + 1) * slice) of the item, sums them per
group in float32 (the streamed part from device memory, then the resident
part), the CTAs' sums are added in rank order, and each CTA normalises its
resident part from shared memory and re-reads the rest, the most recently
read first. Here:

- ``plan`` at every shape of the SD sweep (``chip_smoke.gn_sweep``: the SD
  serves' GroupNorm calls at LR 256 and 128) and of ``GN_SHAPES``, with the
  H100's limits: the slices cover each group once, no CTA keeps more than
  the capacity, and the route is the expected one;
- a torch emulation of that order, on plans made for a small capacity so
  that tiny shapes take both routes, both layouts and ragged slices, held
  against ``fused_group_norm_plain`` and the JAX package's Pallas kernel in
  interpret mode (tolerances as ``tests/test_torch_port_group_norm.py``:
  float32 1e-5 absolute + 1e-5 relative, the same sums in another order;
  bf16 1e-2 + 1e-2, one bf16 rounding of the output);
- the wrapper's device path on CPU tensors with a fake C function, as
  ``tests/test_torch_port_chain_core.py`` does: which C entry and route each
  dtype, layout and shape reaches with which arguments, and that a failing
  launch raises without falling back;
- the sweep's count of the SD GroupNorm calls (hooks on one UNet forward and
  one decode on the meta device) against forward hooks on a tiny SD serve.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import GN_F32_SHAPES, GN_SHAPES, gn_sweep, hooked_group_norm_calls, sd_group_norm_calls
from dgm_img_super_resolution_tpu.ops.pallas.groupnorm import fused_group_norm as jax_fused_group_norm
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn
from test_torch_port_cuda import GN_ROUTES, GN_SMALL_CAP
from test_torch_port_cuda import GN_SHAPES as CUDA_GN_SHAPES

from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY

# the card's SMs, opt-in shared memory, and clusters of 2, 4, 8 and 16 CTAs that run at once (as
# cudaOccupancyMaxActiveClusters gives them on an NVIDIA H100 80GB HBM3)
H100 = dict(sms=132, smem_cap=232448, active=(66, 30, 15, 7))
NO_16 = (66, 30, 15, 0)  # a card where clusters of 16 do not schedule
# the SD sweep's shapes that stream: groups of 4-16 MB, larger than a cluster of 16 holds, and 64
# groups of 512 or 768 KB, whose least cost is one round of clusters of 2 with a part read again
SD_STREAMED = {(1, 256, 1024, 1024), (1, 128, 1024, 1024), (1, 512, 512, 512), (1, 256, 512, 512),
               (2, 512, 128, 128), (2, 768, 128, 128)}


def _plan_cases():
    cases = [(shape, groups, "resident" if shape not in SD_STREAMED else "streamed")
             for shape, groups, _, _, _ in gn_sweep()]
    cases += [(shape, 32, "resident" if shape[2] < 1024 else "streamed") for shape, _ in GN_SHAPES]
    cases += [(shape, groups, None) for shape, groups in GN_F32_SHAPES]
    cases += [((n, c, h, w), g, None) for n, c, h, w, g in CUDA_GN_SHAPES]
    cases += [((n, c, h, w), g, route) for n, c, h, w, g, _, route in GN_ROUTES]
    return cases


def _check_cover(p: gn.Plan, smem_cap: int):
    """The slices cover [0, units) once, in rank order; no CTA keeps more than fits."""
    at = 0
    for lo, mid, hi in p.slices():
        assert lo == at and lo <= mid <= hi and hi - mid <= p.resident_units
        at = hi
    assert at == p.units
    assert p.resident_units * p.unit_bytes <= p.smem <= (smem_cap - gn.RESERVED) // 16 * 16
    assert p.cluster & (p.cluster - 1) == 0
    assert p.slice_units % p.pixel_units == 0 and p.resident_units % p.pixel_units == 0  # whole pixels
    # where an item holds several groups, each of the kernel's 512 computing threads meets its units at one
    # place of the pixel's run, so that its per-place sums belong to fixed groups
    assert p.item_groups == 1 or 512 % p.pixel_units == 0
    if p.unit_bytes == 16:  # a ring of chunks, each with its barriers: in channels_last boxes of whole pixels
        cu = p.rows * p.pixel_units if p.rows else gn.CHUNK // 16
        assert cu * 16 <= gn.CHUNK
        cps = max(1, -(-p.resident_units // cu))
        assert p.buffers * cps <= gn.MAX_CHUNKS and (p.buffers == 1 or p.route == "resident")
        assert p.smem >= (p.buffers * cps - 1) * gn.CHUNK + (cu * 16 if p.rows else 16)


@pytest.mark.parametrize("shape,groups,route", _plan_cases())
def test_plan_covers_each_group_once(shape, groups, route):
    """With the H100's limits, in both dtypes and layouts, and without
    clusters of 16; at the sweep's shapes NCHW bf16 takes the route of the
    measured best plan (the VAE decoder's groups of 4-16 MB stream, and so do
    the 512 KB groups of (2, 512, 128, 128), in clusters of 2)."""
    n, c, h, w = shape
    for esize in (4, 2):
        for cl in (False, True):
            for active in (H100["active"], NO_16):
                p = gn.plan(n, c, h, w, groups, esize, cl, H100["sms"], H100["smem_cap"], active)
                _check_cover(p, H100["smem_cap"])
                assert p.units * p.unit_bytes == p.item_groups * (c // groups) * h * w * esize
                assert groups % p.item_groups == 0 and (p.item_groups == 1 or cl)
                assert p.cluster <= (16 if active[-1] else 8)
                fits = -(-p.units // p.cluster) * p.unit_bytes <= (H100["smem_cap"] - gn.RESERVED) // 16 * 16
                assert p.route == ("resident" if fits else "streamed")
                if esize == 2 and not cl and active[-1] and route is not None:
                    assert p.route == route, (shape, p)


@pytest.mark.parametrize("c,h,w,groups,esize,cl,align,want", [  # want: (groups an item, unit bytes)
    (64, 13, 7, 32, 4, False, 16, (1, 4)),  # HW * 4 = 364 bytes a channel: float32 units
    (64, 13, 7, 32, 2, True, 16, (8, 16)),  # 2 bf16 channels a pixel: 8 groups make 32 bytes
    (64, 13, 7, 32, 4, True, 16, (4, 16)),  # 2 float32 channels: 4 groups
    (256, 16, 16, 32, 2, False, 16, (1, 16)),
    (256, 16, 16, 32, 2, True, 16, (2, 16)),  # the UNet shape's 8 channels of bf16 a pixel
    (128, 16, 16, 32, 2, True, 16, (4, 16)),  # the VAE shape's 4
    (768, 16, 16, 32, 2, True, 16, (1, 16)),  # 24 channels, 48 bytes: one group an item
    (48, 33, 31, 16, 4, True, 16, (1, 4)),  # 3 channels, 12 bytes: not a power of two
    (64, 16, 16, 32, 2, False, 2, (1, 2)),  # x 2 bytes off a 16-byte boundary
    (32, 1, 1, 8, 4, False, 16, (1, 4)),  # a 1x1 image
])
def test_items_and_units(c, h, w, groups, esize, cl, align, want):
    p = gn.plan(1, c, h, w, groups, esize, cl, **H100, align=align)
    assert (p.item_groups, p.unit_bytes) == want
    if p.item_groups > 1:  # slices and resident parts are whole pixels
        q = p.item_groups * c // groups * esize // p.unit_bytes
        assert p.slice_units % q == 0 and p.resident_units % q == 0


def test_plan_fills_the_card_and_caps_the_slice():
    """The cluster size of least cost over rounds: clusters of 2 fill the
    H100's 132 SMs and take the small and middle groups, up to slices a
    little past the capacity; larger groups take clusters of 8 or 16 on 120
    or 112 SMs; 32 groups need two rounds of the 30 clusters of 4 that run
    at once, and one round where 33 run; ``cluster`` forces a size."""
    def at(shape, **kw):
        p = gn.plan(*shape, 32, 2, False, **{**H100, **kw})
        return p.route, p.cluster, p.slice_units * p.unit_bytes

    assert at((2, 1024, 16, 16)) == ("resident", 2, 8192)  # 64 groups of 16 KB: one round of clusters of 2
    assert at((1, 512, 32, 32)) == ("resident", 2, 16384)
    assert at((2, 1536, 64, 64)) == ("resident", 2, 196608)  # 384 KB groups
    assert at((2, 512, 128, 128)) == ("streamed", 2, 262144)  # 512 KB groups: 35 KB a CTA read again
    assert at((1, 512, 128, 128)) == ("resident", 8, 65536)  # 3 rounds of 15 clusters of 8
    assert at((1, 512, 128, 128), active=(66, 33, 16, 8)) == ("resident", 4, 131072)  # one round of 33 of 4
    assert at((2, 256, 256, 256)) == ("resident", 8, 131072)  # 1 MB groups
    assert at((2, 768, 256, 256)) == ("resident", 16, 196608)  # 3 MB groups
    p = gn.plan(2, 768, 256, 256, 32, 2, False, H100["sms"], H100["smem_cap"], NO_16)
    assert (p.route, p.cluster, p.resident_units * p.unit_bytes) == ("streamed", 8, H100["smem_cap"] - gn.RESERVED)
    assert at((1, 512, 32, 32), cluster=1) == ("resident", 1, 32768)


def emulate(x, scale, bias, groups, eps, act, p: gn.Plan):
    """The kernel's arithmetic in its order, in float32: per CTA the sums of
    each group of the item over its streamed then its resident units, the
    cluster's sums in rank order, then the resident units normalised from a
    copy and the streamed ones re-read in blocks of 512 units (one a
    computing thread), the last block first, each as x * mul +
    add with mul = rstd * scale and add = bias - mean * mul. Every element is
    written exactly once."""
    n, c, h, w = x.shape
    cg, hw, gb = c // groups, h * w, p.item_groups
    cl = gn._channels_last(x)
    e = p.unit_bytes // x.element_size()
    xf = x.float()
    if cl:  # an item: gb groups, pixel-major, its gb * cg channels within a pixel
        v = xf.permute(0, 2, 3, 1).reshape(n, hw, groups // gb, gb * cg).permute(0, 2, 1, 3)
        v = v.reshape(n, groups // gb, -1)
        chan = torch.arange(hw * gb * cg) % (gb * cg)
    else:  # channel-major: the group is one run
        v = xf.reshape(n, groups, -1)
        chan = torch.arange(cg * hw) // hw
    member = chan // cg  # the item's group of each element
    out = torch.empty_like(v)
    written = torch.zeros(v.shape, dtype=torch.int32)
    cnt = torch.tensor(float(cg) * float(hw))
    for ni in range(n):
        for it in range(groups // gb):
            row = v[ni, it]
            s, ss = torch.zeros(gb), torch.zeros(gb)
            for lo, mid, hi in p.slices():  # rank order
                for g in range(gb):
                    cta = [row[a * e:b * e][member[a * e:b * e] == g] for a, b in ((lo, mid), (mid, hi))]
                    s[g] = s[g] + (cta[0].sum() + cta[1].sum())
                    ss[g] = ss[g] + ((cta[0] * cta[0]).sum() + (cta[1] * cta[1]).sum())
            mean = s / cnt
            rstd = torch.rsqrt(ss / cnt - mean * mean + eps)
            ch = it * gb * cg + chan

            def norm(vals, idx):
                g = member[idx]
                mul = rstd[g] * scale.float()[ch[idx]]
                y = vals * mul + (bias.float()[ch[idx]] - mean[g] * mul)
                if act == "silu":
                    y = y * torch.sigmoid(y)
                out[ni, it, idx] = y
                written[ni, it, idx] += 1

            for lo, mid, hi in p.slices():
                norm(row[mid * e:hi * e].clone(), torch.arange(mid * e, hi * e))  # resident, from the copy
                for top in range(mid, lo, -512):  # re-read in blocks of 512 units, the last block first
                    back = torch.arange(max(lo, top - 512) * e, top * e)
                    norm(row[back], back)
    assert bool((written == 1).all())
    if cl:
        y = out.reshape(n, groups // gb, hw, gb * cg).permute(0, 2, 1, 3).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return y.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return out.reshape(x.shape).to(x.dtype)


def _inputs(n, c, h, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h, w, c)) * 2.0 + 0.5).astype(np.float32)  # NHWC, off-centre
    return x, (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32), (0.1 * rng.standard_normal(c)).astype(np.float32)


def _port(x_nhwc, channels_last, dtype):
    t = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(dtype)  # a channels_last view
    return t if channels_last else t.contiguous()


# (N, C, H, W, groups, capacity past the reserved bytes, cluster, the
# routes in NCHW and channels_last): the small capacities send these tiny
# items down the streamed route with ragged slices; in clusters of 16 the
# 35-unit groups (NCHW) and 70-unit items of 8 groups (channels_last) leave
# the last slices empty
EMULATED = [
    (2, 32, 8, 8, 8, 32, 16, ("streamed", "streamed")),
    (1, 48, 9, 7, 16, 32, 16, ("streamed", "streamed")),
    (2, 16, 5, 7, 4, 48, 8, ("streamed", "streamed")),
    (2, 16, 5, 7, 16, 64, 16, ("resident", "streamed")),
    (1, 32, 6, 10, 8, 4096, 1, ("resident", "resident")),
]


@pytest.mark.parametrize("n,c,h,w,groups,cap,cluster,routes", EMULATED)
@pytest.mark.parametrize("channels_last", [False, True])
def test_emulated_order_matches_plain_and_pallas(n, c, h, w, groups, cap, cluster, routes, channels_last):
    x, scale, bias = _inputs(n, c, h, w, seed=c + h + w)
    xt = _port(x, channels_last, torch.float32)
    p = gn.plan(n, c, h, w, groups, 4, channels_last, 132, gn.RESERVED + cap, H100["active"], cluster=cluster)
    _check_cover(p, gn.RESERVED + cap)
    assert p.route == routes[channels_last]
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    for act, eps in ((None, 1e-6), ("silu", 1e-5)):
        got = emulate(xt, s, b, groups, eps, act, p)
        assert got.is_contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
        torch.testing.assert_close(got, gn.fused_group_norm_plain(xt, s, b, groups, eps, act), rtol=1e-5, atol=1e-5)
        ref = jax_fused_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=groups, eps=eps,
                                   act=act, interpret=True)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels_last", [False, True])
def test_emulated_order_bfloat16(channels_last):
    """bf16 input, streamed: 4-byte units in NCHW (54 pixels a channel)
    over a cluster of 4; in channels_last items of 2 groups (16 channels, 32
    bytes a pixel) over a cluster of 8, whose last slice is ragged."""
    x, scale, bias = _inputs(2, 64, 6, 9, seed=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = _port(np.array(xb.astype(jnp.float32)), channels_last, torch.bfloat16)
    p = gn.plan(2, 64, 6, 9, 8, 2, channels_last, 132, gn.RESERVED + 96, H100["active"], cluster=4 + 4 * channels_last)
    assert (p.unit_bytes, p.cluster, p.route) == ((16, 8) if channels_last else (4, 4)) + ("streamed",)
    assert bool(p.units % p.slice_units) == channels_last
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    got = emulate(xt, s, b, 8, 1e-5, "silu", p)
    torch.testing.assert_close(got.float(), gn.fused_group_norm_plain(xt, s, b, 8, 1e-5, "silu").float(),
                               rtol=1e-2, atol=1e-2)
    ref = jax_fused_group_norm(xb, jnp.asarray(scale), jnp.asarray(bias), groups=8, act="silu", interpret=True)
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def _fake_library(monkeypatch, rc=0, clusters16=7):
    """A stand-in for ``csrc/group_norm.cu``'s C functions: each call is
    recorded as (function, arguments) after checking the argument count;
    the launch returns ``rc``, the limits query reports an H100 whose
    clusters of 16 schedule ``clusters16`` at a time."""
    calls = []

    def function(lib, fn, n_ptrs, n_ints, n_floats=0):
        assert lib == "group_norm"

        def call(*args):
            assert len(args) == 1 + n_ptrs + n_ints + n_floats + 1, (fn, len(args))
            calls.append((fn, args))
            if fn == "dgmsr_group_norm_limits":
                out = (ctypes.c_int * 6).from_address(args[1])
                out[:] = [H100["sms"], H100["smem_cap"], *H100["active"][:3], clusters16]
                return 0
            return rc
        return call

    monkeypatch.setattr(K, "on_cpu", lambda *t: False)
    monkeypatch.setattr(K, "stream_ptr", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(gn, "function", function)
    gn.device_limits.cache_clear()
    gn._calls.clear()
    return calls


ROUTES = [  # (shape, groups, dtype, channels_last, route, unit bytes)
    ((2, 256, 64, 64), 32, torch.bfloat16, False, "resident", 16),
    ((2, 256, 64, 64), 32, torch.bfloat16, True, "resident", 16),
    ((2, 64, 13, 7), 32, torch.float32, False, "resident", 4),
    ((2, 64, 13, 7), 32, torch.float32, True, "resident", 16),  # items of 4 groups: 32 bytes a pixel
    ((1, 32, 1024, 1024), 8, torch.bfloat16, False, "streamed", 16),  # 8 MB groups
    ((1, 32, 1024, 1024), 8, torch.bfloat16, True, "streamed", 16),  # items of 4 groups, 32 MB
    ((3, 32, 1, 1), 8, torch.float32, True, "resident", 4),  # a 1x1 image is NCHW-contiguous too
]


@pytest.mark.parametrize("shape,groups,dtype,cl,route,ub", ROUTES)
def test_each_dtype_layout_and_shape_reaches_one_launch(monkeypatch, shape, groups, dtype, cl, route, ub):
    """One ``dgmsr_group_norm`` call a call, with the plan's arguments, the
    layout flag and the dtype code, counted under its route; the output
    keeps x's dtype and layout."""
    calls = _fake_library(monkeypatch)
    x = torch.empty(shape, dtype=dtype)
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    fgn = gn.fused_group_norm
    before = fgn.launches, fgn.launches_resident, fgn.launches_streamed
    out = fgn(x, torch.ones(shape[1]), torch.zeros(shape[1]), groups, 1e-6, "silu")
    assert [fn for fn, _ in calls] == ["dgmsr_group_norm_limits", "dgmsr_group_norm"]
    args = calls[-1][1]
    p = gn.plan(*shape, groups, x.element_size(), cl and shape[2] * shape[3] > 1, **H100)
    assert (p.route, p.unit_bytes) == (route, ub)
    assert args[0] == (1 if dtype == torch.bfloat16 else 0) and args[1] == x.data_ptr() and args[4] == out.data_ptr()
    cg_shift = (shape[1] // groups).bit_length() - 1 if p.item_groups > 1 else 0
    assert tuple((ctypes.c_int * 16).from_address(args[5])) == (
        shape[0], shape[1], shape[2] * shape[3], groups, int(cl and shape[2] * shape[3] > 1), p.unit_bytes, 1,
        p.cluster, p.item_groups, cg_shift, p.units, p.slice_units, p.resident_units, p.buffers, p.rows, p.smem)
    assert args[6] == pytest.approx(1e-6)
    resident = route == "resident"
    assert (fgn.launches, fgn.launches_resident, fgn.launches_streamed) == (
        before[0] + 1, before[1] + resident, before[2] + (not resident))
    fmt = torch.channels_last if cl else torch.contiguous_format
    assert out.dtype == dtype and out.shape == x.shape and out.is_contiguous(memory_format=fmt)


@pytest.mark.parametrize("clusters16,want", [(7, 16), (0, 8)])
def test_device_limits_offer_clusters_of_16_where_they_schedule(monkeypatch, clusters16, want):
    """The limits carry the card's clusters at once by size; the plan takes
    clusters of 16 only where they schedule (the 3 MB groups of (2, 768,
    256, 256) take 16 on the H100)."""
    _fake_library(monkeypatch, clusters16=clusters16)
    sms, smem_cap, active = gn.device_limits(0)
    assert (sms, smem_cap, active) == (H100["sms"], H100["smem_cap"], (*H100["active"][:3], clusters16))
    assert gn.plan(2, 768, 256, 256, 32, 2, False, sms, smem_cap, active).cluster == want
    gn.device_limits.cache_clear()


def test_a_failing_launch_raises_rather_than_falling_back(monkeypatch):
    _fake_library(monkeypatch, rc=1)
    monkeypatch.setattr(gn, "fused_group_norm_plain", lambda *a: pytest.fail("fell back to the plain version"))
    fgn = gn.fused_group_norm
    before = fgn.launches, fgn.launches_resident, fgn.launches_streamed
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fgn(torch.empty(2, 64, 8, 8), torch.ones(64), torch.zeros(64), 32)
    assert (fgn.launches, fgn.launches_resident, fgn.launches_streamed) == before
    gn.device_limits.cache_clear()


def test_sweep_counts_match_hooks_on_a_tiny_serve():
    """``sd_group_norm_calls`` at the tiny configs (one UNet forward on the
    CFG batch counted ``steps`` times, one decode, on the meta device)
    against forward hooks on a 2-step serve of the tiny SD pipeline."""
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    pipe = StableDiffusionUpscalePipeline(unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY,
                                          dtype=torch.float32, device="cpu", seed=3)
    img = np.random.default_rng(4).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    got = hooked_group_norm_calls([pipe.unet, pipe.vae], lambda: pipe.upscale_device(
        "a cat", img, num_inference_steps=2, guidance_scale=9.0, noise_level=5))
    assert got == sd_group_norm_calls(8, steps=2, unet_cfg=UNET_TINY, vae_cfg=VAE_TINY)
    assert sum(sd_group_norm_calls(256).values()) == 1244  # the LR 256 serve's RowwiseMoments launches (PERF.md §5)
