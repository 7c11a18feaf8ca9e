"""Image rows split over the members of a group: the hook through which the
models' conv sites reach a spatial split (the counterpart of the halo
exchanges that GSPMD inserts around the JAX package's convolutions when
image rows are sharded, ``parallel/mesh.py:126 shard_spatial``).

A :class:`RowGroup` names this process's place in the group (``index`` of
``size``) and reduces a tensor in place over the members. Rows are split
evenly, in order: member ``index`` holds the ``index``-th of ``size`` equal
runs of rows of every NCHW tensor of the call, at every resolution. The
models import this module and nothing of ``parallel/``, which installs a
group over ``torch.distributed`` for the duration of a spatial call
(:class:`split`). Without one, :func:`active` is None and every site runs
as before.

Under a split the sites (``models/layers.py``, ``metrics/psnr_ssim.py``)
take their neighbours' rows through :func:`halo`, an exact all-reduce
(sum) of a zero-filled buffer ``[size, 2, N, C, k, W]`` into which each
member writes its top and bottom ``k`` rows; a member at the image's outer
edge gets zero rows there, which a reflect pad then overwrites
(:func:`reflect_pad1`). Statistics over the whole image (GroupNorm's, the
pixel softmax of linear attention) add the members' sums through
:func:`all_sum`. Both are ``autograd`` Functions whose backward is the same
collective with the roles swapped: a halo's gradient goes home to the
member that owns those rows and is added there. Every member runs the same
graph, so the members call their collectives in one order, forward and
backward.

The group is thread-local, so that one process may drive several members
(the tests do, one thread a member).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

_STATE = threading.local()


class RowGroup:
    """This member's ``index`` among ``size`` that split an image's rows,
    and the in-place reduction over them (``op`` "sum" or "max")."""

    def __init__(self, index: int, size: int):
        self.index, self.size = int(index), int(size)

    @property
    def first(self) -> bool:
        """Holds the image's top rows."""
        return self.index == 0

    @property
    def last(self) -> bool:
        """Holds the image's bottom rows."""
        return self.index == self.size - 1

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> None:
        raise NotImplementedError


class split:
    """Context manager under which the conv sites split their rows over
    ``group`` (None: no split). Re-entrant; the previous group comes back
    on exit. ``trace``: a list to which each collective appends ``(kind,
    shape, dtype)``, or None."""

    def __init__(self, group: RowGroup | None, trace: list | None = None):
        self.group, self.trace = group, trace

    def __enter__(self):
        self._prev = (active(), getattr(_STATE, "trace", None))
        _STATE.group, _STATE.trace = self.group, self.trace
        return self

    def __exit__(self, *exc):
        _STATE.group, _STATE.trace = self._prev
        return False


def active() -> RowGroup | None:
    """The group of the split in force in this thread, or None."""
    return getattr(_STATE, "group", None)


def _note(kind: str, t: torch.Tensor) -> None:
    trace = getattr(_STATE, "trace", None)
    if trace is not None:
        trace.append((kind, tuple(t.shape), t.dtype))


class _AllSum(torch.autograd.Function):
    """The sum over the members, on every member; its gradient is the sum
    of the members' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        group.all_reduce_(out, "sum")
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.group.all_reduce_(g, "sum")
        return g, None


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the members of the active group (differentiable)."""
    _note("sum", t)
    return _AllSum.apply(t, active())


def all_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the members, with no gradient."""
    _note("max", t)
    out = t.detach().clone()
    active().all_reduce_(out, "max")
    return out


class _Halo(torch.autograd.Function):
    """``x`` with its neighbours' ``k`` rows above and below (zeros at the
    image's outer edges)."""

    @staticmethod
    def forward(ctx, x, group, k):
        ctx.group, ctx.k = group, k
        i = group.index
        buf = x.new_zeros((group.size, 2) + tuple(x.shape[:2]) + (k, x.shape[3]))
        buf[i, 0] = x[:, :, :k]
        buf[i, 1] = x[:, :, -k:]
        group.all_reduce_(buf, "sum")
        top = buf[i - 1, 1] if not group.first else torch.zeros_like(buf[i, 0])
        bottom = buf[i + 1, 0] if not group.last else torch.zeros_like(buf[i, 0])
        return torch.cat([top, x, bottom], 2)

    @staticmethod
    def backward(ctx, g):
        group, k = ctx.group, ctx.k
        i = group.index
        buf = g.new_zeros((group.size, 2) + tuple(g.shape[:2]) + (k, g.shape[3]))
        if not group.first:  # my top halo came from the bottom rows of the member above
            buf[i - 1, 1] = g[:, :, :k]
        if not group.last:
            buf[i + 1, 0] = g[:, :, -k:]
        group.all_reduce_(buf, "sum")
        gx = g[:, :, k:-k].clone()
        gx[:, :, :k] += buf[i, 0]
        gx[:, :, -k:] += buf[i, 1]
        return gx, None, None


def halo(x: torch.Tensor, k: int) -> torch.Tensor:
    """NCHW ``x`` with ``k`` rows of the neighbours above and below it, and
    ``k`` zero rows where it meets the image's top or bottom."""
    if x.shape[2] < k:
        raise ValueError(f"a halo of {k} rows needs at least {k} rows a member, not {x.shape[2]}")
    _note("halo", x)
    return _Halo.apply(x, active(), k)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad(1) of this member's rows: the neighbours' rows at an
    inner edge, the reflected row at the image's top and bottom (which may
    be a neighbour's when a member holds one row)."""
    group = active()
    ext = halo(x, 1)
    if group.first:
        ext = torch.cat([ext[:, :, 2:3], ext[:, :, 1:]], 2)
    if group.last:
        ext = torch.cat([ext[:, :, :-1], ext[:, :, -3:-2]], 2)
    ext = torch.cat([ext[:, :, :, 1:2], ext, ext[:, :, :, -2:-1]], 3)
    return ext.contiguous(memory_format=torch.channels_last) if ext.is_cuda else ext


def conv2d(x, weight, bias, stride, padding) -> torch.Tensor:
    """A zero-padded conv of stride 1 whose row padding is half its kernel
    (the RRDB's 3x3, the SSIM window) over this member's rows."""
    kh = weight.shape[2]
    (sh, _), (ph, pw) = _pair(stride), _pair(padding)
    if sh != 1 or 2 * ph != kh - 1:
        raise NotImplementedError(f"row split of a conv with kernel {kh}, stride {sh}, padding {ph}")
    return F.conv2d(halo(x, ph), weight, bias, stride, (0, pw))


def conv_transpose2d(x, weight, bias, stride, padding, output_padding) -> torch.Tensor:
    """A transposed conv over this member's rows: input row i writes
    output rows s i - p .. s i - p + k - 1, so the member takes the input
    rows whose outputs reach its own s n rows (one each side for the
    Upsample's k4 s2 p1 and the condition's k 2s, s, s/2), convolves them
    unpadded in rows and keeps its output rows."""
    (sh, sw), (ph, pw), (oh, ow) = _pair(stride), _pair(padding), _pair(output_padding)
    kh = weight.shape[2]
    if oh:
        raise NotImplementedError("row split of a transposed conv with output padding in rows")
    k = max((kh - 1 - ph) // sh, (sh + ph - 1) // sh, 0)
    ext = halo(x, k) if k else x
    y = F.conv_transpose2d(ext, weight, bias, (sh, sw), (0, pw), (0, ow))
    start = sh * k + ph
    return y[:, :, start: start + sh * x.shape[2]]


def group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float) -> torch.Tensor:
    """``F.group_norm`` over the whole image from this member's rows: the
    groups' sums and then their squared deviations added over the members
    (rows split evenly, so the count is the member's times ``size``)."""
    n, c = x.shape[:2]
    xg = x.reshape(n, groups, -1)
    count = xg.shape[-1] * active().size
    mean = all_sum(xg.sum(-1)) / count
    d = xg - mean[..., None]
    var = all_sum((d * d).sum(-1)) / count
    y = (d * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    return y * weight.view(1, c, 1, 1) + bias.view(1, c, 1, 1)


def pixel_softmax(k: torch.Tensor) -> torch.Tensor:
    """The softmax of ``k`` over the last axis, the pixels of the whole
    image, from this member's pixels: the members' max, then their sums of
    the exponentials, in float32 at least."""
    kf = k.to(torch.promote_types(k.dtype, torch.float32))
    e = torch.exp(kf - all_max(kf.amax(-1, keepdim=True)))
    return (e / all_sum(e.sum(-1, keepdim=True))).to(k.dtype)


def _pair(v) -> tuple[int, int]:
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))
