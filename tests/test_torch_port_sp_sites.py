"""The row split's sites (``ops/rowsplit.py`` under ``models/layers.py``,
``ops/resize.py`` and ``metrics/psnr_ssim.py``) in one process, with no
spawn: W members, one thread each, reduce through an in-process all-reduce
(:class:`ThreadGroup`), so the halo exchange and the sums run their real
``autograd`` Functions, forward and backward. Each member takes its rows of
the whole input (a halo comes from its neighbours' threads); its output
rows, and the input and weight gradients summed over the members, are held
against the whole op's, in float32, within 1e-5 of the largest |value|
(the members add their sums in another order than one pass over the whole).

W = 2 and 4, with one row a member at the deepest stage where the op has
stages: the reflect pad at the image's top then reads the neighbour's row.
"""

import copy
import threading

import numpy as np
import pytest
import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.metrics.psnr_ssim import ssim
from dgm_img_super_resolution_tpu_torch.models import layers as L
from dgm_img_super_resolution_tpu_torch.models.rrdb import RRDBNet
from dgm_img_super_resolution_tpu_torch.models.unet import Unet
from dgm_img_super_resolution_tpu_torch.ops import rowsplit
from dgm_img_super_resolution_tpu_torch.ops.resize import resize

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny ops gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Hub:
    """What the members' threads share: a barrier and a slot each."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=60)
        self.slots: list = [None] * size


class ThreadGroup(rowsplit.RowGroup):
    """A row group whose members are threads of this process: each reduce
    adds (or maxes) the members' tensors in member order."""

    def __init__(self, hub: Hub, index: int):
        super().__init__(index, hub.size)
        self.hub = hub

    def all_reduce_(self, t, op="sum"):
        hub = self.hub
        hub.slots[self.index] = t.clone()
        hub.barrier.wait()
        parts = torch.stack(hub.slots)
        red = parts.sum(0) if op == "sum" else parts.amax(0)
        hub.barrier.wait()
        t.copy_(red)


def run_members(size: int, fn) -> list:
    """``fn(index)`` on ``size`` threads, each under a split of its own
    member; their results in member order."""
    hub, out, errors = Hub(size), [None] * size, []

    def work(i):
        try:
            with rowsplit.split(ThreadGroup(hub, i)):
                out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - handed to the test's thread
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


def rows_of(x: torch.Tensor, i: int, size: int) -> torch.Tensor:
    per = x.shape[2] // size
    return x[:, :, i * per:(i + 1) * per]


class Fn(nn.Module):
    """A function of the inputs and of this module's parameters."""

    def __init__(self, fn, **params):
        super().__init__()
        self.fn = fn
        self.p = nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})

    def forward(self, *xs):
        return self.fn(*xs, **self.p)


class Layer(nn.Module):
    """``models/layers.py:conv`` over a layer's parameters."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        return L.conv(x, self.layer)


def _t(g, *shape):
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32))


def _seeded(module, g):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(_t(g, *p.shape) * 0.5)
    return module


def make_case(name: str, h: int):
    """(the module, its inputs) of a site at height ``h``: every 4-D input
    is split by rows, anything else is whole on every member."""
    g = np.random.default_rng(sum(map(ord, name)) + h)
    n, w = 2, 6
    if name == "reflect3x3":
        return Fn(lambda x, w, b: L.reflect_conv3x3(x, w, b), w=_t(g, 5, 3, 3, 3), b=_t(g, 5)), [_t(g, n, 3, h, w)]
    if name == "reflect3x3_stride2":
        return (Fn(lambda x, w, b: L.reflect_conv3x3(x, w, b, stride=2), w=_t(g, 4, 3, 3, 3), b=_t(g, 4)),
                [_t(g, n, 3, h, w)])
    if name == "zero3x3":
        return _seeded(Layer(nn.Conv2d(4, 5, 3, 1, 1)), g), [_t(g, n, 4, h, w)]
    if name == "upsample_convt":
        return _seeded(L.Upsample(4), g), [_t(g, n, 4, h, w)]
    if name == "cond_convt":
        return _seeded(Layer(nn.ConvTranspose2d(4, 3, 8, 4, 2)), g), [_t(g, n, 4, h, w)]
    if name == "group_norm_block":
        return _seeded(L.Block(3, 8, groups=2), g), [_t(g, n, 3, h, w)]
    if name == "linear_attention":
        return _seeded(L.LinearAttention(8, heads=2, dim_head=4), g), [_t(g, n, 8, h, w)]
    if name == "rrdb":
        return _seeded(RRDBNet(out_nc=3, nf=8, nb=2, gc=4), g), [_t(g, n, 3, h, w).clamp(-1, 1)]
    if name == "unet":
        unet = _seeded(Unet(dim=8, dim_mults=(1, 2, 3), cond_dim=4, rrdb_num_block=2, groups=0), g)
        return unet, [_t(g, n, 3, h, 8), torch.tensor([3, 7]), _t(g, n, 4, h // 4, 2)]
    raise KeyError(name)


# (case, W, H): every member holds H / W rows; the last of each site has one row a member at its
# deepest stage (the UNet: at the third, its HR rows 16 / 4 / 4)
CASES = [("reflect3x3", 2, 8), ("reflect3x3", 4, 4), ("reflect3x3_stride2", 2, 8), ("reflect3x3_stride2", 4, 8),
         ("zero3x3", 2, 6), ("zero3x3", 4, 4), ("upsample_convt", 2, 4), ("upsample_convt", 4, 4),
         ("cond_convt", 2, 4), ("cond_convt", 4, 4), ("group_norm_block", 2, 8), ("group_norm_block", 4, 4),
         ("linear_attention", 2, 6), ("linear_attention", 4, 4), ("rrdb", 2, 4), ("rrdb", 4, 4),
         ("unet", 2, 16), ("unet", 4, 16)]


def _close(got, want, label, tol=TOL):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert err <= tol * scale, (label, err, scale)


def _compare(module, inputs, split, size, mean=False, tol=TOL):
    """The whole op against ``size`` members, forward and backward."""
    whole_in = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
    want = module(*whole_in)
    gout = torch.from_numpy(np.random.default_rng(7).standard_normal(want.shape)).to(want.dtype)
    (want * gout).sum().backward()
    want_grads = [x.grad for x in whole_in]
    want_w = {k: p.grad for k, p in module.named_parameters()}

    def member(i):
        mod = copy.deepcopy(module)
        mod.zero_grad()
        xs = [(rows_of(x, i, size) if s else x).clone().requires_grad_(x.is_floating_point())
              for x, s in zip(inputs, split)]
        y = mod(*xs)
        loss = y * gout / size if mean else (y * rows_of(gout, i, size)).sum()
        loss.sum().backward()
        return y.detach(), [x.grad for x in xs], {k: p.grad for k, p in mod.named_parameters()}

    got = run_members(size, member)
    if mean:
        _close(sum(o[0] for o in got) / size, want.detach(), "output", tol)
    else:
        _close(torch.cat([o[0] for o in got], 2), want.detach(), "output", tol)
    for j, (s, wg) in enumerate(zip(split, want_grads)):
        if wg is None:
            continue
        parts = [o[1][j] for o in got]
        _close(torch.cat(parts, 2) if s else sum(parts), wg, f"input {j} grad", tol)
    for k, wg in want_w.items():
        _close(sum(o[2][k] for o in got), wg, f"{k} grad", tol)


@pytest.mark.parametrize("name,size,h", CASES, ids=[f"{c}-W{s}-H{h}" for c, s, h in CASES])
def test_site_matches_the_whole_op(name, size, h):
    module, inputs = make_case(name, h)
    split = [x.ndim == 4 for x in inputs]
    _compare(module, inputs, split, size)


@pytest.mark.parametrize("size,h", [(2, 16), (4, 20)])
def test_ssim_window_matches_the_whole_image(size, h):
    """The loss SSIM's 11x11 window takes 5 rows of halo, zeros at the
    image's outer rows; the mean of the members' means is the whole mean."""
    g = np.random.default_rng(h)
    a, b = (torch.from_numpy(g.uniform(-1, 1, (2, 3, h, 12)).astype(np.float32)) for _ in range(2))
    _compare(Fn(lambda x, y: ssim(x, y)), [a, b], [True, True], size, mean=True)


@pytest.mark.parametrize("size,h", [(2, 8), (4, 16)])
def test_resize_rows_are_the_whole_resize_rows(size, h):
    """The serve's x4 bicubic: each member's rows of the H matrix applied
    to the whole LR give its rows of the whole resize (no collective)."""
    x = torch.from_numpy(np.random.default_rng(h).uniform(-1, 1, (2, 3, h, 10)).astype(np.float32))
    x.requires_grad_(True)
    want = resize(x, (4 * h, 40), variant="torch")
    gout = torch.from_numpy(np.random.default_rng(3).standard_normal(want.shape).astype(np.float32))
    (want * gout).sum().backward()
    per, grads = 4 * h // size, []
    for i in range(size):
        xi = x.detach().clone().requires_grad_(True)
        yi = resize(xi, (4 * h, 40), variant="torch", rows=slice(i * per, (i + 1) * per))
        _close(yi.detach(), want.detach()[:, :, i * per:(i + 1) * per], f"rows of member {i}")
        (yi * gout[:, :, i * per:(i + 1) * per]).sum().backward()
        grads.append(xi.grad)
    _close(sum(grads), x.grad, "input grad")


@pytest.mark.parametrize("size", [2, 4])
def test_unet_with_attention_is_exact_in_float64(size):
    """The UNet with the mid linear attention, in float64: the split equals
    the whole op but for rounding (1e-12), so what float32 shows beyond its
    own rounding is none of the split's. (GroupNorm Blocks normalise in
    float32 whatever the dtype; their site is held above.)"""
    g = np.random.default_rng(size)
    unet = Unet(dim=8, dim_mults=(1, 2, 3), cond_dim=4, rrdb_num_block=2, use_attn=True, dtype=torch.float64)
    with torch.no_grad():
        for p in unet.parameters():
            fan = int(np.prod(p.shape[1:])) if p.ndim > 1 else 4
            p.copy_(torch.from_numpy(g.standard_normal(p.shape) / np.sqrt(fan)))
    unet.double()
    x, c = (torch.from_numpy(g.standard_normal(s)) for s in ((2, 3, 16, 8), (2, 4, 4, 2)))
    _compare(unet, [x, torch.tensor([3, 7]), c], [True, False, True], size, tol=1e-12)


def test_without_a_split_the_sites_run_as_before():
    """No group in force: ``active()`` is None, and a split of None leaves
    it None; a site under a split in one thread does not leak into another."""
    assert rowsplit.active() is None
    with rowsplit.split(None):
        assert rowsplit.active() is None
    seen = []
    with rowsplit.split(ThreadGroup(Hub(1), 0)):
        t = threading.Thread(target=lambda: seen.append(rowsplit.active()))
        t.start()
        t.join()
        assert rowsplit.active() is not None
    assert seen == [None] and rowsplit.active() is None


def test_the_trace_records_each_collective():
    """``split(trace=...)`` lists the halo exchanges and sums of a call."""
    trace = []
    x = torch.zeros(1, 4, 4, 5)

    def member(i):
        with rowsplit.split(rowsplit.active(), trace if i == 0 else None):
            L.conv(x, nn.Conv2d(4, 5, 3, 1, 1))
            rowsplit.all_sum(torch.ones(2))
        return None

    run_members(2, member)
    assert trace == [("halo", (1, 4, 4, 5), torch.float32), ("sum", (2,), torch.float32)]


def test_unsupported_convs_raise_under_a_split():
    """A stride-2 zero conv, or a stride-2 reflect conv over an odd count
    of rows a member, has no row split: it raises rather than pad a shard's
    edge as the image's."""
    def member(i):
        with pytest.raises(NotImplementedError):
            L.conv(torch.zeros(1, 4, 4, 4), nn.Conv2d(4, 4, 3, 2, 1))
        with pytest.raises(ValueError, match="even"):
            L.reflect_conv3x3(torch.zeros(1, 4, 3, 4), torch.zeros(4, 4, 3, 3), stride=2)
        return True

    assert run_members(2, member) == [True, True]
