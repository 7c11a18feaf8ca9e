"""GroupNorm + affine + optional SiLU (counterpart of the JAX package's
``ops/pallas/groupnorm.py:fused_group_norm``).

As in the JAX package, nothing calls it yet: the SD modules normalise with
``nn.GroupNorm``. ``fused_group_norm`` runs the plain PyTorch version on CPU
tensors and the hand-written CUDA kernel of ``csrc/group_norm.cu`` on CUDA
tensors, one launch a call. It takes (N,C,H,W)-shaped tensors held
NCHW-contiguous or channels_last and returns the same layout. The statistics
follow the JAX kernel: sums of x and x^2 in float32 and ``var = E[x^2] -
mean^2`` (``F.group_norm`` uses Welford's update instead).

The kernel's layout of the work is ``plan``'s, a pure function of the shape,
the layout, the dtype and the card's limits: persistent thread-block
clusters, each taking one item (a group; in channels_last a block of
consecutive groups) at a time, each CTA a slice of the item, the slices
resident in shared memory (the "resident" route: x read once) or, for
slices larger than a CTA holds, the last part of each slice resident and the
rest read again (the "streamed" route). The cluster size is the one whose
rounds of items (one an active cluster a round) cost the least.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels._build import function

ACTS = (None, "silu")
RESERVED = 6144  # bytes of a CTA's shared memory kept for its static arrays (csrc/group_norm.cu:RESERVED)
ROUND_BYTES = 24 * 1024  # a round's fixed cost (the cluster's exchange of sums, its barriers), in bytes moved
CLUSTERS = (2, 4, 8, 16)  # the cluster sizes past 1 (16 is non-portable: only where the card schedules it)
CHUNK = 8192  # bytes of one bulk copy into the ring (csrc/group_norm.cu:CHUNK)
MAX_CHUNKS = 32  # chunks the ring has barriers for
MAX_BUFFERS = 4  # slices in the ring: items the producer may run ahead
RUN_BYTES = 32  # a channels_last item's bytes a pixel, where groups are blocked to reach it
MAX_GB = 8  # groups an item at most


@dataclass(frozen=True)
class Plan:
    route: str  # "resident" or "streamed"
    item_groups: int  # groups of an item, the work of one cluster at a time: 1 in NCHW
    unit_bytes: int  # bytes of a unit, a contiguous run of the item (16 at most)
    units: int  # units of an item
    cluster: int  # CTAs of the cluster that takes an item
    slice_units: int  # units a CTA: rank r takes [r * slice_units, (r + 1) * slice_units) of the item
    resident_units: int  # the last of them (at most this many) stay in shared memory
    buffers: int  # slices of the ring of shared memory (16-byte units), else 1
    rows: int  # pixels a box of the channels_last ring (0 elsewhere)
    pixel_units: int  # units of a pixel's run of the item (channels_last: slices are whole pixels); 1 in NCHW
    smem: int  # dynamic shared memory a CTA, bytes

    def slices(self) -> list[tuple[int, int, int]]:
        """(first unit, first resident unit, end) of each rank's slice, as the
        kernel cuts it: [first, resident) is read again, [resident, end) is
        kept in shared memory."""
        out = []
        for r in range(self.cluster):
            lo = min(r * self.slice_units, self.units)
            hi = min(lo + self.slice_units, self.units)
            out.append((lo, hi - min(hi - lo, self.resident_units), hi))
        return out


def item_groups(c: int, groups: int, esize: int, channels_last: bool) -> int:
    """Groups of an item: 1 in NCHW, where a group is one run. In
    channels_last a group is a run of C / G channels a pixel; where that run
    is a power of two under ``RUN_BYTES`` bytes, an item takes enough
    consecutive groups (at most ``MAX_GB``, dividing G) for a run of
    ``RUN_BYTES``, so that no 32-byte sector is read or written in part."""
    run = c // groups * esize
    if not channels_last or run >= RUN_BYTES or run & (run - 1):
        return 1
    gb = min(RUN_BYTES // run, MAX_GB)
    while groups % gb:
        gb //= 2
    return gb


def unit_bytes(run: int, esize: int, align: int = 16) -> int:
    """The largest of 16, 8, 4 or 2 bytes (not below one element) dividing
    ``run`` (the bytes a unit must not cross: a channel's plane in NCHW, an
    item's channels a pixel in channels_last) and the data's alignment."""
    ub = 16
    while ub > esize and (run % ub or align % ub):
        ub //= 2
    return ub


@lru_cache(maxsize=4096)
def plan(n: int, c: int, h: int, w: int, groups: int, esize: int, channels_last: bool, sms: int, smem_cap: int,
         active: tuple[int, ...], align: int = 16, cluster: int = 0) -> Plan:
    """The kernel's work for one call. ``esize``: bytes of an element;
    ``sms``: the card's SM count; ``smem_cap``: the shared memory a CTA may
    opt in to; ``active``: how many clusters of each size of ``CLUSTERS``
    run at once (0 where a size does not schedule; a CTA takes a whole SM);
    ``align``: the largest power of two up to 16 dividing x's address;
    ``cluster``: the cluster size to take, else (0) the cheapest.

    The clusters that run at once take the items in rounds, one item a
    cluster a round: ceil(items / clusters at once) rounds. A round costs
    the bytes of a slice, once more the bytes of it that do not fit and are
    read again, and ``ROUND_BYTES``. The cluster size of least cost is
    taken, the smaller on a tie: clusters of 2 fill every SM, larger ones
    leave some idle (on an H100, 132 SMs hold 66, 30, 15 and 7 clusters of
    2, 4, 8 and 16) but cut the slice. The route is resident when a slice
    fits in ``smem_cap - RESERVED`` bytes (rounded down to 16). In channels_last,
    slices and resident parts are
    whole pixels. With 16-byte units the kernel's producer fills a ring of
    ``CHUNK``-byte chunks (bulk copies in NCHW; in channels_last boxes of
    ``rows`` pixels of the item's channels, at most 256 channels wide), and
    the rest of the shared memory holds up to ``MAX_BUFFERS`` slices of it,
    so that the producer loads later items while the current one is
    stored."""
    cg, hw = c // groups, h * w
    gb = item_groups(c, groups, esize, channels_last)
    run = gb * cg * esize if channels_last else hw * esize
    ub = unit_bytes(run, esize, align)
    if channels_last and ub == 16 and run // esize > 256:
        ub = 8  # wider than a box: the threads load the units themselves
    units = gb * cg * hw * esize // ub
    q = run // ub if channels_last else 1  # units a pixel, where slices are whole pixels
    room = (smem_cap - RESERVED) // 16 * 16  # the shared memory is given in whole 16-byte lines
    rows = min(256, CHUNK // run, max(1, room // run)) if channels_last and ub == 16 else 0
    cu = rows * q if rows else CHUNK // 16  # units a chunk of the ring holds
    if rows:  # whole chunks of boxes, the last box whole too
        cap = ((room - cu * 16) // CHUNK + 1) * cu if room >= cu * 16 else 0
    else:
        cap = room // ub // q * q
    if cap < 1:
        raise ValueError(f"shared memory of {smem_cap} bytes holds no unit")
    items = n * groups // gb

    def per_cta(k: int) -> int:
        return -(-units // k // q) * q if q > 1 else -(-units // k)

    at_once = {1: sms, **dict(zip(CLUSTERS, active))}

    def cost(k: int) -> int:
        return -(-items // at_once[k]) * ((per_cta(k) + max(0, per_cta(k) - cap)) * ub + ROUND_BYTES)

    k = cluster or min((k for k, a in at_once.items() if a > 0), key=lambda k: (cost(k), k))
    sl = per_cta(k)
    resident = min(sl, cap)
    buffers, smem = 1, -(-resident * ub // 16) * 16
    if ub == 16:
        cps = max(1, -(-resident // cu))  # chunks of a slice
        last = cu * 16 if rows else smem - (cps - 1) * CHUNK  # the ring's last chunk: a whole box in channels_last
        buffers = max(1, min(MAX_BUFFERS, MAX_CHUNKS // cps, ((room - last) // CHUNK + 1) // cps))
        smem = (buffers * cps - 1) * CHUNK + last
    return Plan(route="resident" if sl <= cap else "streamed", item_groups=gb, unit_bytes=ub, units=units,
                cluster=k, slice_units=sl, resident_units=resident, buffers=buffers, rows=rows, pixel_units=q,
                smem=smem)


@lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int, tuple[int, ...]]:
    """(SM count, shared memory a CTA may opt in to, how many clusters of
    each size of ``CLUSTERS`` run at once, 0 where a size does not schedule)
    of CUDA device ``index``."""
    out = (ctypes.c_int * (2 + len(CLUSTERS)))()
    with torch.cuda.device(index):
        rc = function("group_norm", "dgmsr_group_norm_limits", 1, 0)(1, ctypes.addressof(out), K.stream_ptr())
    K.raise_on_error(rc, "fused_group_norm limits")
    return out[0], out[1], tuple(out[2:])


def _channels_last(x: torch.Tensor) -> bool:
    """Held channels_last, and not also NCHW-contiguous (as a 1x1 image is)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def plan_for(x: torch.Tensor, groups: int) -> Plan:
    """The plan of a call on the CUDA tensor ``x``."""
    n, c, h, w = x.shape
    sms, smem_cap, active = device_limits(x.device.index if x.device.index is not None else 0)
    ptr = x.data_ptr()
    return plan(n, c, h, w, groups, x.element_size(), _channels_last(x), sms, smem_cap, active,
                align=ptr & -ptr if ptr % 16 else 16)


def fused_group_norm_plain(x, scale, bias, groups: int = 32, eps: float = 1e-5, act: str | None = None):
    """Plain composition of the JAX kernel's arithmetic, in float32, cast
    back to the dtype of ``x``."""
    n, c = x.shape[:2]
    xg = x.float().reshape(n, groups, -1)
    cnt = xg.shape[-1]
    mean = xg.sum(-1, keepdim=True) / cnt
    var = (xg * xg).sum(-1, keepdim=True) / cnt - mean * mean
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    fmt = torch.channels_last if _channels_last(x) else torch.contiguous_format
    return y.to(x.dtype).contiguous(memory_format=fmt)


@K.counted
def fused_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5, act: str | None = None):
    """x: (N,C,H,W); scale, bias: (C,); ``act``: None or "silu". CUDA
    tensors launch the kernel once, on the route ``plan_for`` gives; the
    counters ``launches``, ``launches_resident`` and ``launches_streamed``
    count the launches."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    if K.on_cpu(x, scale, bias):
        return fused_group_norm_plain(x, scale, bias, groups, eps, act)
    return _launch(x, scale, bias, groups, eps, act, None)


def _params(n, c, h, w, groups, cl, act, p: Plan):
    """The kernel's 16 int parameters (``csrc/group_norm.cu:dgmsr_group_norm``)."""
    cg_shift = (c // groups).bit_length() - 1 if p.item_groups > 1 else 0
    return (ctypes.c_int * 16)(n, c, h * w, groups, int(cl), p.unit_bytes, int(act == "silu"), p.cluster,
                               p.item_groups, cg_shift, p.units, p.slice_units, p.resident_units, p.buffers, p.rows,
                               p.smem)


_calls: dict = {}  # (shape, dtype, contiguous, groups, act, device, address % 16) -> (plan, cl, params)


def _launch(x, scale, bias, groups, eps, act, p: Plan | None):
    """The kernel on CUDA tensors, on plan ``p`` (``plan_for``'s if None).
    The plan and the kernel's parameters of each kind of call are kept, so
    that a repeated call spends little time on the host."""
    n, c, h, w = x.shape
    code = K.dtype_code(x)
    contiguous = x.is_contiguous()
    if not (contiguous or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("the group_norm kernel needs an NCHW-contiguous or a channels_last tensor")
    K.check_param("scale", scale, (c,))
    K.check_param("bias", bias, (c,))
    key = None if p else (x.shape, x.dtype, contiguous, groups, act, x.device.index, x.data_ptr() & 15)
    call = _calls.get(key) if key else None
    if call is None:
        if c // groups * h * w * MAX_GB >= 2**31:
            raise ValueError(f"a group of {c // groups * h * w} elements is more than the kernel indexes")
        p = p or plan_for(x, groups)
        cl = not contiguous
        call = (p, cl, _params(n, c, h, w, groups, cl, act, p))
        if key:
            if len(_calls) >= 4096:
                _calls.clear()
            _calls[key] = call
    p, cl, params = call
    out = torch.empty_like(x)
    sc = scale if scale.dtype == torch.float32 and scale.is_contiguous() else scale.float().contiguous()
    bi = bias if bias.dtype == torch.float32 and bias.is_contiguous() else bias.float().contiguous()
    rc = function("group_norm", "dgmsr_group_norm", 5, 0, 1)(
        code, x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), ctypes.addressof(params), eps,
        K.stream_ptr())
    K.raise_on_error(rc, "fused_group_norm")
    fused_group_norm.launches += 1
    if p.route == "resident":
        fused_group_norm.launches_resident += 1
    else:
        fused_group_norm.launches_streamed += 1
    return out


fused_group_norm.launches = 0
fused_group_norm.launches_resident = 0
fused_group_norm.launches_streamed = 0
