"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On a GPU machine,
from the root of the repository (``--noconftest``: the suite's conftest
sets up JAX, which these tests do not need):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances: float32 with TF32 off, 1e-4 of max(1, max |plain|) (sums in
another order over up to 4 chained convs); bfloat16, 3e-2 of the same (the
kernels round where the plain versions do, but a one-ulp difference in an
early bf16 intermediate moves later ones by an ulp of theirs). Flash
attention is held at the same two tolerances against max |plain| alone (its
outputs are convex mixes of v, well under 1): in bf16 the kernel rounds p
against the running max of each 128-key tile where the plain version rounds
it against the row's max. Gradients (float32, TF32 off): 1e-3 of max |plain
grad| per input through one region, and of max |CPU grad| per parameter
through the hidden-64 UNet (``chip_smoke.GRAD_TOL``); the regions' backward
recomputes the plain version, so only the forward's sum order and cuDNN's
backward algorithms differ.
"""

import pytest
import torch

from chip_smoke import CONFIGS, CONV64_EDGES, CORE_REGIONS, GRAD_TOL, SERVE_LAUNCHES, WIDE_CORE_WIDTHS, Regions
from chip_smoke import CUDNN_ENV, FWD_F32_RATIO_MAX, FWD_F32_RATIO_MEAN, FWD_MAX_REL, FWD_MEAN_REL
from chip_smoke import backward_inputs, chain_inputs, head_piece_args, tail_args
from chip_smoke import _counters, _read_counts, _reset_counts, core_edge_args, flash_inputs, forward_launches, grad_errors
from chip_smoke import switches, unet_grads
from chip_smoke import ENCPROP_RUNS, encprop_launches

pytestmark = pytest.mark.cuda

SHAPES = [(1, 8, 8), (2, 26, 38), (1, 40, 72)]  # (B, HR H, HR W): ragged against the 8x16 tile


@pytest.fixture
def kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {
        "stem": (bc.block_chain3_stem, bc.block_chain3_stem_plain),
        "chain": (bc.block_chain3, bc.block_chain3_plain),
        "tail": (tf.tail_fuse, tf.tail_fuse_plain),
        "stem_ds": (bc.block_chain3_stem_ds, bc.block_chain3_stem_ds_plain),
        "head": (bc.block_chain3_head, bc.block_chain3_head_plain),
        "conv3x3": (k3.conv3x3, k3.conv3x3_plain),
    }


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("region", ["stem", "chain", "tail", "stem_ds", "head", "conv3x3"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_kernel_matches_plain(kernels, region, dtype, tol, b, h, w):
    kern, plain = kernels[region]
    args = getattr(Regions(b, h, w, dtype, "cuda", seed=h * w + b), region)
    before = kern.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = plain(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, wt in zip(got, want):
        assert g.shape == wt.shape and g.dtype == wt.dtype
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert _rel_err(g, wt) <= tol


@pytest.mark.parametrize("region", ["stem", "chain", "tail", "stem_ds", "head", "conv3x3"])
def test_kernel_backward_matches_plain(kernels, region):
    """With grad on, the wrapper goes through ``Recompute``: one launch
    forward, none backward, and the plain version's gradients. The backward
    recomputes the plain version, so this checks the gradient plumbing (every
    input, optional and tuple parts); the kernel's numbers are held by
    ``test_kernel_matches_plain``, and a backward through kernel activations
    by ``test_unet_backward_matches_cpu``."""
    kern, plain = kernels[region]
    b, h, w = 2, 26, 38
    args = getattr(Regions(b, h, w, torch.float32, "cuda", seed=h + w + b), region)
    g = torch.Generator().manual_seed(b)

    def grads(fn, check_fn=False):
        leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a for a in args]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        if check_fn:
            assert all(type(o.grad_fn).__name__ == "RecomputeBackward" for o in outs)
        cots = [torch.randn(o.shape, generator=g).to(o.device, o.dtype) for o in outs]
        return torch.autograd.grad(outs, [t for t in leaves if isinstance(t, torch.Tensor)], cots)

    before = kern.launches
    got = grads(kern, check_fn=True)
    torch.cuda.synchronize()
    assert kern.launches == before + 1  # the forward launched once, the backward nothing
    g.manual_seed(b)
    want = grads(plain)
    for i, (gt, wt) in enumerate(zip(got, want)):
        assert gt.shape == wt.shape and bool(torch.isfinite(gt).all()), i
        assert (gt - wt).abs().max().item() <= GRAD_TOL * wt.abs().max().item(), i


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_unet_backward_matches_cpu(kernels, cfg):
    """The hidden-64 UNet forward through the kernels of each configuration
    and backward on the card: every parameter gets a finite gradient that
    matches the CPU's (plain versions) on the same weights and inputs."""
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    hp = Hparams(compute_dtype="float32")
    cpu = SRDiffPipeline(hp, device="cpu").model
    gpu = SRDiffPipeline(hp, params=cpu.state_dict()).model.denoise_fn
    x, t, cond, r = backward_inputs()
    _, want, _ = unet_grads(cpu.denoise_fn, x, t, cond, r)
    with switches(**CONFIGS[cfg]):
        _, got, launched = unet_grads(gpu, x.cuda(), t.cuda(), cond.cuda(), r.cuda(), _counters())
    assert launched == forward_launches(cfg)
    worst, bad = grad_errors(got, want)
    assert not bad, (bad[:5], worst)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_unet_bf16_forward_launch_counts(kernels, cfg):
    """One bf16 UNet call of the hidden-64 model under each configuration
    launches a twentieth of the ddim20 serve's kernels
    (``chip_smoke.SERVE_LAUNCHES``), the calls on the conv core
    (``<wrapper>_wgmma``, the tail's among them) included."""
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    unet = SRDiffPipeline(Hparams(compute_dtype="bfloat16")).model.denoise_fn
    x, t, cond, _ = backward_inputs()
    counters = _counters()
    with switches(**CONFIGS[cfg]), torch.inference_mode():
        _reset_counts(counters)
        eps = unet(x.cuda(), t.cuda(), cond.cuda())
        torch.cuda.synchronize()
    assert bool(torch.isfinite(eps).all())
    launched = {k: v for k, v in _read_counts(counters).items() if v}
    want = {k: v // 20 for k, v in SERVE_LAUNCHES[cfg].items()}
    assert launched == want


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_unet_bf16_forward_matches_cudnn_and_float32(kernels, cfg):
    """The served bf16 path end to end: one bf16 UNet call of the hidden-64
    model under each configuration against the same weights' bf16 call with
    every region off (cuDNN throughout) and their float32 call (TF32 off),
    within chip_smoke's bounds (``FWD_MAX_REL``, ``FWD_MEAN_REL``, and at
    most ``FWD_F32_RATIO_MAX`` / ``_MEAN`` times as far from float32 as the
    cuDNN bf16 call; the reasons are there)."""
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    pipe = SRDiffPipeline(Hparams(compute_dtype="bfloat16"))
    f32 = SRDiffPipeline(Hparams(compute_dtype="float32"), params=pipe.model.state_dict())
    x, t, cond, _ = backward_inputs()
    x, t, cond = x.cuda(), t.cuda(), cond.cuda()

    def eps(p, env):
        with switches(**env), torch.inference_mode():
            return p.model.denoise_fn(x, t, cond).float()

    def dist(a, b):
        d = (a - b).abs()
        return (d.max() / b.abs().max()).item(), (d.mean() / b.abs().mean()).item()

    ref32, ref16 = eps(f32, CUDNN_ENV), eps(pipe, CUDNN_ENV)
    base = dist(ref16, ref32)
    got = eps(pipe, CONFIGS[cfg])
    assert bool(torch.isfinite(got).all())
    vs16, vs32 = dist(got, ref16), dist(got, ref32)
    assert vs16[0] <= FWD_MAX_REL and vs16[1] <= FWD_MEAN_REL, vs16
    assert vs32[0] <= FWD_MAX_REL and vs32[1] <= FWD_MEAN_REL, vs32
    assert vs32[0] <= FWD_F32_RATIO_MAX * base[0] and vs32[1] <= FWD_F32_RATIO_MEAN * base[1], (vs32, base)


def test_head_and_ds_launches_at_tile_edges(kernels):
    """The bf16 head launch (C_s = 64 and 128) writing (h1, r1), and the
    bf16 Downsample launch, alone against their plain pieces: the head at
    each ``CONV64_EDGES`` shape (odd and even H, W), the Downsample where
    its output has that shape (its input at twice it)."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    for b, h, w in CONV64_EDGES:
        for cs in bc.HEAD_CORE_WIDTHS:
            args = head_piece_args(b, cs, h, w, seed=h * w + b + cs)
            for g, wt in zip(bc._launch_head(*args), bc.head_h1_plain(*args)):
                assert g.shape == wt.shape and g.is_contiguous(memory_format=torch.channels_last)
                assert _rel_err(g, wt) <= 3e-2, (cs, b, h, w)
        gen = torch.Generator().manual_seed(h * w + b)
        out = torch.randn(b, 64, 2 * h, 2 * w, generator=gen).to("cuda", torch.bfloat16)
        out = out.contiguous(memory_format=torch.channels_last)
        wds, bds = (torch.randn(64, 64, 3, 3, generator=gen) / 24).cuda(), (torch.randn(64, generator=gen) * 0.1).cuda()
        got = bc._launch_ds(out, wds, bds)
        torch.cuda.synchronize()
        want = bc.ds_plain(out, wds, bds)
        assert got.shape == want.shape == (b, 64, h, w) and got.is_contiguous(memory_format=torch.channels_last)
        assert _rel_err(got, want) <= 3e-2, (b, h, w)


def test_head_and_ds_counters(kernels):
    """bf16 Downsample folds and heads at C_s = 64 and 128 count in
    ``launches_ds_wgmma`` / ``launches_head_wgmma``; float32 ones, and a
    bf16 head at C_s = 192, run ``block_chain.cu`` and count there only in
    ``launches``."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    stem_ds, head = bc.block_chain3_stem_ds, bc.block_chain3_head
    for dtype, core in ((torch.bfloat16, 1), (torch.float32, 0)):
        r = Regions(2, 34, 130, dtype, "cuda", seed=5)
        before = stem_ds.launches, stem_ds.launches_ds_wgmma, head.launches, head.launches_head_wgmma
        stem_ds(*r.stem_ds)
        head(*r.head)
        torch.cuda.synchronize()
        got = stem_ds.launches, stem_ds.launches_ds_wgmma, head.launches, head.launches_head_wgmma
        assert got == (before[0] + 1, before[1] + core, before[2] + 1, before[3] + core)
    args = head_piece_args(2, 192, 9, 70, seed=192)
    r = Regions(2, 18, 140, torch.bfloat16, "cuda", seed=6)
    before = head.launches, head.launches_head_wgmma
    got = head(*args[:6], *r.head[6:])
    torch.cuda.synchronize()
    assert (head.launches, head.launches_head_wgmma) == (before[0] + 1, before[1])
    assert _rel_err(got, bc.block_chain3_head_plain(*args[:6], *r.head[6:])) <= 3e-2


# conv3x3 at C = 64 also on every edge of the bf16 kernel's 2-row x 64-pixel
# tiles (chip_smoke.CONV64_EDGES): W one pixel short of, at and past a tile
# (and two tiles), H at the reflect minimum, odd and ragged, one image and three


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("border", ["zero", "reflect"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_conv3x3_widths_borders_and_odd_sizes(kernels, c, border, dtype, tol):
    """bf16 at C = 64 runs the warpgroup-MMA kernel (``launches_wgmma``
    counts it), the rest the tiled mma.sync kernel."""
    conv, plain = kernels["conv3x3"]
    g = torch.Generator().manual_seed(c)
    wgmma = int(dtype == torch.bfloat16 and c == 64)
    for b, h, w in ((1, 2, 3), (2, 13, 21), (1, 33, 17)) + (tuple(CONV64_EDGES) if c == 64 else ()):
        x = torch.randn(b, c, h, w, generator=g).to("cuda", dtype).contiguous(memory_format=torch.channels_last)
        wc = (torch.randn(c, c, 3, 3, generator=g) / (3 * c**0.5)).cuda()
        bc = (torch.randn(c, generator=g) * 0.1).cuda()
        for act in (False, True):
            before = conv.launches, conv.launches_wgmma
            got = conv(x, wc, bc, border, act)
            torch.cuda.synchronize()
            assert (conv.launches, conv.launches_wgmma) == (before[0] + 1, before[1] + wgmma)
            assert _rel_err(got, plain(x, wc, bc, border, act)) <= tol, (b, h, w, act)


@pytest.mark.parametrize("region", CORE_REGIONS)
def test_chain_core_at_tile_edges(kernels, region):
    """The bf16 C = 64 chain of every region on the conv core, on each edge
    of its tiles (``CONV64_EDGES``; the Downsample fold at the next even H
    and W): each call counts one launch and one call on the core, and
    matches the plain version at the bf16 tolerance."""
    kern, plain = kernels[region.removesuffix("_cond")]
    for b, h, w in CONV64_EDGES:
        args = core_edge_args(region, b, h, w)
        before = kern.launches, kern.launches_wgmma
        got = kern(*args)
        torch.cuda.synchronize()
        assert (kern.launches, kern.launches_wgmma) == (before[0] + 1, before[1] + 1)
        want = plain(*args)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, wt in zip(got, want):
            assert g.shape == wt.shape and g.is_contiguous(memory_format=torch.channels_last)
            assert _rel_err(g, wt) <= 3e-2, (b, h, w)


def test_chain_core_front_pieces(kernels):
    """The stem launch writing (h1, r1) and the h1 pass (at every core
    width), alone, against their plain versions at ragged shapes."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    for b, h, w in ((1, 2, 3), (3, 17, 65), (2, 26, 130)):
        r = Regions(b, 2 * h, 2 * w, torch.bfloat16, "cuda", seed=b + h + w)
        x, wa, ba, wr, br, tv1 = r.stem[:6]
        for g, wt in zip(bc._launch_stem(x, wa, ba, wr, br, tv1), bc.stem_h1_plain(x, wa, ba, wr, br, tv1)):
            assert _rel_err(g, wt) <= 3e-2, (b, h, w)
        a_pre, _, tv1 = r.chain[:3]
        assert _rel_err(bc._launch_h1(a_pre, tv1), bc.h1_plain(a_pre, tv1)) <= 3e-2, (b, h, w)
        for c in WIDE_CORE_WIDTHS:
            a_pre, _, tv1 = chain_inputs(b, c, h, w, torch.bfloat16, "cuda", seed=c + h)[0][:3]
            assert _rel_err(bc._launch_h1(a_pre, tv1), bc.h1_plain(a_pre, tv1)) <= 3e-2, (c, b, h, w)


def test_tail_core_at_tile_edges(kernels):
    """The bf16 tail on the conv core at each ``CONV64_EDGES`` shape of its
    input (the ConvT's tiles; the 3x3's at twice that): each call counts one
    launch and one call on the core, and matches the plain version at the
    bf16 tolerance."""
    tail, plain = kernels["tail"]
    for b, h, w in CONV64_EDGES:
        args = tail_args(b, h, w, torch.bfloat16, "cuda", seed=h * w + b)
        before = tail.launches, tail.launches_wgmma
        got = tail(*args)
        torch.cuda.synchronize()
        assert (tail.launches, tail.launches_wgmma) == (before[0] + 1, before[1] + 1)
        want = plain(*args)
        assert got.shape == want.shape == (b, 3, 2 * h, 2 * w)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert _rel_err(got, want) <= 3e-2, (b, h, w)


def test_tail_core_launches_alone(kernels):
    """The core route's two launches alone against their plain pieces at
    ragged shapes: the ConvT writing y, and the 3x3 + Mish + 1x1 over y (at
    cout 1, 3, 4, 5 and 8: both widths of the hook's 1x1 weight)."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    for b, h, w in ((1, 2, 3), (3, 17, 65), (2, 26, 130)):
        for cout in (1, 3, 4, 5, 8):
            x, wt, bt, wf, bf, wo, bo = tail_args(b, h, w, torch.bfloat16, "cuda", seed=b + h + w, cout=cout)
            y = tf._launch_convt(x, wt, bt)
            assert _rel_err(y, tf.convt_plain(x, wt, bt)) <= 3e-2, (b, h, w)
            got = tf._launch_conv_mish_1x1(y, wf, bf, wo, bo)
            assert _rel_err(got, tf.conv_mish_1x1_plain(y, wf, bf, wo, bo)) <= 3e-2, (b, h, w, cout)


@pytest.mark.parametrize("dtype,cout,tol", [(torch.float32, 3, 1e-4), (torch.bfloat16, 12, 3e-2)])
def test_tail_off_the_core_runs_the_tiled_conv(kernels, dtype, cout, tol):
    """float32, and bf16 with more outputs than the core's hook takes, run
    ``tail_fuse.cu``: counted in ``launches``, not in ``launches_wgmma``."""
    tail, plain = kernels["tail"]
    args = tail_args(2, 17, 65, dtype, "cuda", seed=cout, cout=cout)
    before = tail.launches, tail.launches_wgmma
    got = tail(*args)
    torch.cuda.synchronize()
    assert (tail.launches, tail.launches_wgmma) == (before[0] + 1, before[1])
    assert _rel_err(got, plain(*args)) <= tol


@pytest.mark.parametrize("c", WIDE_CORE_WIDTHS)
def test_wide_chain_core_at_tile_edges(kernels, c):
    """The bf16 chain at C = 128, 192 and 256 on the wide conv core, on
    each edge of its tiles (``CONV64_EDGES``), with and without its
    condition: each call counts one launch and one call on the core, and
    matches the plain version at the bf16 tolerance."""
    chain, plain = kernels["chain"]
    for cond in (False, True):
        for b, h, w in CONV64_EDGES:
            args = chain_inputs(b, c, h, w, torch.bfloat16, "cuda", seed=h * w + b + c, cond=cond)[0]
            before = chain.launches, chain.launches_wgmma
            got = chain(*args)
            torch.cuda.synchronize()
            assert (chain.launches, chain.launches_wgmma) == (before[0] + 1, before[1] + 1)
            want = plain(*args)
            assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
            assert _rel_err(got, want) <= 3e-2, (cond, b, h, w)


@pytest.mark.parametrize("c", [32, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,w", [(2, 13, 21), (1, 2, 35)])
def test_chain_at_every_width(kernels, c, dtype, tol, b, h, w):
    """The chain off C = 64: the resident kernel at 32, the wide kernel
    above (N slices of 32 channels at 96, of 64 at 128-256), but bf16 at
    128-256 on the conv core; with the condition; H and W not multiples of
    the tiles. Counted per (C, H, W), and on the core where it runs there."""
    chain, plain = kernels["chain"]
    args, _ = chain_inputs(b, c, h, w, dtype, "cuda", seed=c + h, cond=True)
    before, before_c, before_core = chain.launches, chain.launches_by_shape.get((c, h, w), 0), chain.launches_wgmma
    got = chain(*args)
    torch.cuda.synchronize()
    assert chain.launches == before + 1 and chain.launches_by_shape[c, h, w] == before_c + 1
    assert chain.launches_wgmma == before_core + (dtype == torch.bfloat16 and c in WIDE_CORE_WIDTHS)
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel_err(got, want) <= tol


def test_wrappers_raise_on_what_the_kernels_do_not_take(kernels):
    stem, _ = kernels["stem"]
    chain, _ = kernels["chain"]
    stem_ds, _ = kernels["stem_ds"]
    head, _ = kernels["head"]
    conv, _ = kernels["conv3x3"]
    args = Regions(1, 16, 16, torch.float32, "cuda").chain
    nchw = (args[0].contiguous(),) + args[1:]
    with pytest.raises(ValueError, match="channels_last"):
        chain(*nchw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        chain(*((args[0].half(),) + args[1:]))
    narrow = Regions(1, 16, 16, torch.float32, "cuda").stem
    x32 = narrow[0]
    wa = torch.zeros(32, 3, 3, 3, device="cuda")
    with pytest.raises(ValueError, match="C=64"):
        stem(x32, wa, *narrow[2:])
    with pytest.raises(ValueError, match="several devices"):
        chain(*((args[0].cpu(),) + args[1:]))
    for c in (80, 544):
        with pytest.raises(ValueError, match=f"32..512 by 32, got C={c}"):
            chain(*chain_inputs(1, c, 4, 4, torch.float32, "cuda")[0])

    ds_args = Regions(1, 10, 14, torch.float32, "cuda").stem_ds
    with pytest.raises(ValueError, match="even H, W"):
        stem_ds(ds_args[0][:, :, :9], *ds_args[1:])
    head_args = Regions(1, 16, 16, torch.float32, "cuda").head
    x96 = head_args[0][:, :96].contiguous(memory_format=torch.channels_last)
    wa96 = head_args[2][:, :192].contiguous()
    wr96 = head_args[4][:, :192].contiguous()
    with pytest.raises(ValueError, match="multiples of 64"):
        head(x96, x96, wa96, head_args[3], wr96, *head_args[5:])
    with pytest.raises(ValueError, match="channels_last"):
        head(head_args[0].contiguous(), *head_args[1:])
    x = torch.randn(1, 16, 8, 8, device="cuda").contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="C=32 and C=64"):
        conv(x, torch.zeros(16, 16, 3, 3, device="cuda"), torch.zeros(16, device="cuda"))
    x = torch.randn(1, 32, 8, 8, device="cuda")
    w32, b32 = torch.zeros(32, 32, 3, 3, device="cuda"), torch.zeros(32, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        conv(x, w32, b32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv(x.half().contiguous(memory_format=torch.channels_last), w32, b32)
    with pytest.raises(ValueError, match="several devices"):
        conv(x.contiguous(memory_format=torch.channels_last), w32.cpu(), b32)


@pytest.fixture
def group_norm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn

    return gn


GN_SHAPES = [  # (N, C, H, W, groups): ragged; vector and scalar paths; one group over many blocks
    (2, 64, 13, 7, 32), (2, 256, 16, 16, 32), (1, 64, 128, 128, 32), (1, 48, 33, 31, 16), (3, 32, 1, 1, 8),
]


@pytest.mark.parametrize("n,c,h,w,groups", GN_SHAPES)
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_group_norm_matches_plain(group_norm, n, c, h, w, groups, channels_last, dtype, tol):
    g = torch.Generator().manual_seed(c + h)
    x = (torch.randn(n, c, h, w, generator=g) * 2 + 0.5).to("cuda", dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    scale, bias = (1 + 0.1 * torch.randn(c, generator=g)).cuda(), (0.1 * torch.randn(c, generator=g)).cuda()
    for act in (None, "silu"):
        before = group_norm.fused_group_norm.launches
        got = group_norm.fused_group_norm(x, scale, bias, groups, 1e-5, act)
        torch.cuda.synchronize()
        assert group_norm.fused_group_norm.launches == before + 1
        want = group_norm.fused_group_norm_plain(x, scale, bias, groups, 1e-5, act)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.is_contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
        assert _rel_err(got, want) <= tol


# (N, C, H, W, groups, dtype, the route the card's plan takes): a group that
# a cluster holds, and groups larger than a cluster of 16 holds at the
# largest slice (16 MB in bf16, 32 MB in float32)
GN_ROUTES = [(2, 256, 64, 64, 32, torch.bfloat16, "resident"), (1, 64, 128, 128, 32, torch.float32, "resident"),
             (1, 256, 1024, 1024, 32, torch.bfloat16, "streamed"), (1, 32, 1024, 1024, 4, torch.float32, "streamed")]


def _gn_inputs(n, c, h, w, dtype, channels_last, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, c, h, w, generator=g) * 2 + 0.5).to("cuda", dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x, (1 + 0.1 * torch.randn(c, generator=g)).cuda(), (0.1 * torch.randn(c, generator=g)).cuda()


@pytest.mark.parametrize("n,c,h,w,groups,dtype,route", GN_ROUTES)
@pytest.mark.parametrize("channels_last", [False, True])
def test_group_norm_routes_count_and_repeat(group_norm, n, c, h, w, groups, dtype, route, channels_last):
    """Each route at a shape the card's plan sends to it: one launch a call,
    counted under its route; two calls bit-equal; the plain version's
    tolerance."""
    fgn = group_norm.fused_group_norm
    x, scale, bias = _gn_inputs(n, c, h, w, dtype, channels_last, seed=c + h)
    assert group_norm.plan_for(x, groups).route == route
    before = fgn.launches, fgn.launches_resident, fgn.launches_streamed
    got = fgn(x, scale, bias, groups, 1e-6, "silu")
    again = fgn(x, scale, bias, groups, 1e-6, "silu")
    torch.cuda.synchronize()
    two = 2 if route == "resident" else 0
    assert (fgn.launches, fgn.launches_resident, fgn.launches_streamed) == (
        before[0] + 2, before[1] + two, before[2] + 2 - two)
    assert torch.equal(got, again)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert _rel_err(got, group_norm.fused_group_norm_plain(x, scale, bias, groups, 1e-6, "silu")) <= tol


# (N, C, H, W, groups): ragged; 16-byte units in one layout and not the
# other; a 1x1 image
GN_SMALL_CAP = [(2, 64, 13, 7, 32), (1, 48, 33, 31, 16), (2, 32, 16, 24, 4), (3, 32, 1, 1, 8)]


@pytest.mark.parametrize("n,c,h,w,groups", GN_SMALL_CAP)
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cap,cluster", [(64, 16), (64, 8), (256, 4), (256, 2), (4096, 1)])
def test_group_norm_plans_with_a_small_capacity(group_norm, n, c, h, w, groups, channels_last, dtype, tol, cap,
                                                cluster):
    """Plans made for a card with ``cap`` bytes of shared memory a CTA (past
    the reserved ones) and clusters of ``cluster``: at small shapes they take
    clusters of up to 16, empty and ragged slices and the streamed route's
    re-read, each against the plain version."""
    x, scale, bias = _gn_inputs(n, c, h, w, dtype, channels_last, seed=c * h)
    sms, _, active = group_norm.device_limits(0)
    if cluster > 1 and not active[group_norm.CLUSTERS.index(cluster)]:
        cluster = 8  # clusters of 16 do not schedule on this card
    p = group_norm.plan(n, c, h, w, groups, x.element_size(), channels_last and h * w > 1, sms,
                        group_norm.RESERVED + cap, active, cluster=cluster)
    for act in (None, "silu"):
        got = group_norm._launch(x, scale, bias, groups, 1e-5, act, p)
        torch.cuda.synchronize()
        assert _rel_err(got, group_norm.fused_group_norm_plain(x, scale, bias, groups, 1e-5, act)) <= tol


@pytest.mark.parametrize("channels_last", [False, True])
def test_group_norm_unaligned_data(group_norm, channels_last):
    """x at an address 2 bytes past a 16-byte boundary takes 2-byte units."""
    n, c, h, w = 2, 64, 16, 16
    buf = torch.randn(n * c * h * w + 1, device="cuda").to(torch.bfloat16)
    x = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2) if channels_last else buf[1:].view(n, c, h, w)
    scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    assert group_norm.plan_for(x, 32).unit_bytes == 2
    got = group_norm.fused_group_norm(x, scale, bias, 32, 1e-5, "silu")
    torch.cuda.synchronize()
    assert _rel_err(got, group_norm.fused_group_norm_plain(x, scale, bias, 32, 1e-5, "silu")) <= 3e-2


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_elementwise_where_y_is_negative(group_norm, channels_last, dtype):
    """SiLU on normalised values y in about [-8, -2] (x uniform, scale 1.7,
    bias -5), element by element: where the output is 0.03-12% of |y|, an
    approximate sigmoid shows that a norm over the largest value hides.
    bf16 at most one unit in the last place from the plain version (each
    rounds its float32 value once), float32 within 1e-5 of each value."""
    n, c, h, w = 2, 64, 32, 32
    g = torch.Generator().manual_seed(7)
    x = torch.rand(n, c, h, w, generator=g).to("cuda", dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    scale, bias = torch.full((c,), 1.7, device="cuda"), torch.full((c,), -5.0, device="cuda")
    got = group_norm.fused_group_norm(x, scale, bias, 32, 1e-5, "silu")
    want = group_norm.fused_group_norm_plain(x, scale, bias, 32, 1e-5, "silu")
    y = group_norm.fused_group_norm_plain(x.float(), scale, bias, 32, 1e-5, None)
    assert float(y.min()) < -7.5 and float(y.max()) > -2.5
    if dtype == torch.bfloat16:
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()  # all negative: one sign
        assert int(ulps.max()) <= 1
    else:
        assert float(((got - want).abs() / want.abs()).max()) <= 1e-5


def test_group_norm_refusals(group_norm):
    fgn = group_norm.fused_group_norm
    x = torch.randn(1, 64, 8, 8, device="cuda")
    s = torch.ones(64, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fgn(x.half(), s, s)
    with pytest.raises(ValueError, match="several devices"):
        fgn(x, s.cpu(), s)
    with pytest.raises(ValueError, match="multiple of groups"):
        fgn(x, s, s, groups=48)
    with pytest.raises(ValueError, match="NCHW-contiguous or a channels_last"):
        fgn(x[:, :, :, ::2], s, s)


# (B, Lq, Lk, H, D, logit scale): the SD shape, ragged L, a short tile, D = 64,
# cross lengths both ways, and logits x8 (q scaled), which moves the running
# max from tile to tile and exercises the rescale
FLASH_SHAPES = [(2, 1024, 1024, 8, 128, 1), (1, 1089, 1089, 2, 64, 1), (1, 70, 70, 3, 128, 1),
                (2, 64, 64, 1, 64, 1), (1, 100, 333, 2, 64, 1), (1, 333, 100, 2, 128, 1),
                (2, 1024, 1024, 8, 128, 8), (1, 300, 300, 2, 64, 8)]


@pytest.fixture
def flash():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    return fa


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,l,lk,h,d,scale", FLASH_SHAPES)
def test_flash_attention_matches_plain(flash, dtype, tol, b, l, lk, h, d, scale):
    q, k, v = flash_inputs(b, l, h, d, dtype, seed=l + d, lk=lk, scale=scale)
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    want = flash.flash_attention_reference(q, k, v)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


def test_flash_attention_cross_lengths_and_refusals(flash):
    q = flash_inputs(1, 100, 2, 64, torch.float32, 1)[0]
    k, v = flash_inputs(1, 333, 2, 64, torch.float32, 2)[1:]
    got = flash.flash_attention(q, k, v)
    want = flash.flash_attention_reference(q, k, v)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with pytest.raises(ValueError, match="D=96"):
        flash.flash_attention(*flash_inputs(1, 64, 1, 96, torch.float32, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash.flash_attention(*flash_inputs(1, 64, 1, 64, torch.float16, 4))
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


# ------------------------------------------------ serving paths of slice 12
def _serving_pipe(**over):
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    hp = Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype="bfloat16", **over)
    return SRDiffPipeline(hp)


@pytest.mark.parametrize("cfg,k", ENCPROP_RUNS)
def test_encoder_propagation_launches(kernels, cfg, k):
    """The full-width bf16 ddim20 serve with ``enc_interval`` K launches
    ``chip_smoke.encprop_launches``: an encode per group and per remainder
    step, a decode per step (batch 2 at LR 32; counts do not depend on
    size)."""
    import numpy as np

    pipe = _serving_pipe(enc_interval=k)
    counters = _counters()
    imgs = np.random.default_rng(k).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    with switches(**CONFIGS[cfg]):
        _reset_counts(counters)
        out = pipe.upscale_batch_device(imgs)
        torch.cuda.synchronize()
    assert {n: v for n, v in _read_counts(counters).items() if v} == encprop_launches(cfg, k)
    assert out.shape == (2, 128, 128, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("cfg", ["default", "A"])
def test_encode_decode_is_the_full_forward_at_full_width(kernels, cfg):
    """bf16, hidden 64, 1|2|3|4 at 128x128 HR: the split runs the same
    launches on the same inputs, so it is the full forward bit for bit."""
    pipe = _serving_pipe()
    unet = pipe.model.denoise_fn
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(2, 3, 128, 128, device="cuda", generator=g)
    cond = torch.randn(2, 64, 128, 128, device="cuda", generator=g)
    t = torch.tensor([99, 44], device="cuda")
    with switches(**CONFIGS[cfg]), torch.inference_mode():
        full = unet(x, t, cond, cond_projected=True, up_folded=True)
        enc = unet(x, t, cond, cond_projected=True, up_folded=True, mode="encode")
        split = unet(None, t, None, mode="decode", enc_feats=enc)
    assert torch.equal(split, full)


def test_over_budget_chunk_zero_is_the_unchunked_batch(kernels):
    """A budget of 2 images of 128x128 HR: a batch of 3 in two sub-batches
    (the second padded); sub-batch 0 equals the serve of its 2 images with
    the same noise, and the launches are two batches' worth."""
    import numpy as np

    from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import as_noise_hook
    from dgm_img_super_resolution_tpu_torch.inference import ChunkNoise

    pipe = _serving_pipe(max_native_hr_pixels=2 * 128 * 128)
    noise = ChunkNoise(lambda path, shape: as_noise_hook(
        None, shape, "cuda", torch.Generator(device="cuda").manual_seed(50 + sum(path))))
    imgs = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    counters = _counters()
    _reset_counts(counters)
    seen = []
    out = pipe.upscale_batch_device(imgs, noise=noise, progress_cb=lambda d, t: seen.append((d, t)))
    torch.cuda.synchronize()
    assert {n: v for n, v in _read_counts(counters).items() if v} == {n: 2 * v for n, v in
                                                                     SERVE_LAUNCHES["default"].items()}
    assert seen == [(d, 40) for d in range(1, 41)]
    whole = pipe.upscale_batch_device(imgs[:2], noise=noise.fold_in(0).hook((2, 3, 128, 128)))
    assert out.shape == (3, 128, 128, 3)
    assert (out[:2] - whole).abs().max().item() <= 3e-2
