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
against the running max of each 64-key tile where the plain version rounds
it against the row's max.
"""

import pytest
import torch

from chip_smoke import Regions

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


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("border", ["zero", "reflect"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_conv3x3_widths_borders_and_odd_sizes(kernels, c, border, dtype, tol):
    conv, plain = kernels["conv3x3"]
    g = torch.Generator().manual_seed(c)
    for b, h, w in ((1, 2, 3), (2, 13, 21), (1, 33, 17)):
        x = torch.randn(b, c, h, w, generator=g).to("cuda", dtype).contiguous(memory_format=torch.channels_last)
        wc = (torch.randn(c, c, 3, 3, generator=g) / (3 * c**0.5)).cuda()
        bc = (torch.randn(c, generator=g) * 0.1).cuda()
        for act in (False, True):
            assert _rel_err(conv(x, wc, bc, border, act), plain(x, wc, bc, border, act)) <= tol


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


FLASH_SHAPES = [(2, 1024, 8, 128), (1, 1089, 2, 64), (1, 70, 3, 128), (2, 64, 1, 64)]  # (B, L, H, D)


def _qkv(b, l, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, l, h, d, generator=g).to("cuda", dtype) for _ in range(3)]


@pytest.fixture
def flash():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    return fa


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,l,h,d", FLASH_SHAPES)
def test_flash_attention_matches_plain(flash, dtype, tol, b, l, h, d):
    q, k, v = _qkv(b, l, h, d, dtype, seed=l + d)
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    want = flash.flash_attention_reference(q, k, v)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


def test_flash_attention_cross_lengths_and_refusals(flash):
    q = _qkv(1, 100, 2, 64, torch.float32, 1)[0]
    k, v = _qkv(1, 333, 2, 64, torch.float32, 2)[1:]
    got = flash.flash_attention(q, k, v)
    want = flash.flash_attention_reference(q, k, v)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with pytest.raises(ValueError, match="D=96"):
        flash.flash_attention(*_qkv(1, 64, 1, 96, torch.float32, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash.flash_attention(*_qkv(1, 64, 1, 64, torch.float16, 4))
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
