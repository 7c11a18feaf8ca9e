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

from chip_smoke import CONFIGS, CONV64_EDGES, CORE_REGIONS, GRAD_TOL, Regions, backward_inputs, chain_inputs
from chip_smoke import _counters, core_edge_args, flash_inputs, forward_launches, grad_errors, switches, unet_grads

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
    """The stem launch writing (h1, r1) and the h1 pass, alone, against
    their plain versions at ragged shapes."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    for b, h, w in ((1, 2, 3), (3, 17, 65), (2, 26, 130)):
        r = Regions(b, 2 * h, 2 * w, torch.bfloat16, "cuda", seed=b + h + w)
        x, wa, ba, wr, br, tv1 = r.stem[:6]
        for g, wt in zip(bc._launch_stem(x, wa, ba, wr, br, tv1), bc.stem_h1_plain(x, wa, ba, wr, br, tv1)):
            assert _rel_err(g, wt) <= 3e-2, (b, h, w)
        a_pre, _, tv1 = r.chain[:3]
        assert _rel_err(bc._launch_h1(a_pre, tv1), bc.h1_plain(a_pre, tv1)) <= 3e-2, (b, h, w)


@pytest.mark.parametrize("c", [32, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,w", [(2, 13, 21), (1, 2, 35)])
def test_chain_at_every_width(kernels, c, dtype, tol, b, h, w):
    """The chain off C = 64: the resident kernel at 32, the wide kernel
    above (N slices of 32 channels at 96, of 64 at 128-256), with the
    condition; H and W not multiples of the 8x16 tile. Counted per width."""
    chain, plain = kernels["chain"]
    args, _ = chain_inputs(b, c, h, w, dtype, "cuda", seed=c + h, cond=True)
    before, before_c = chain.launches, chain.launches_by_c.get(c, 0)
    got = chain(*args)
    torch.cuda.synchronize()
    assert chain.launches == before + 1 and chain.launches_by_c[c] == before_c + 1
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
