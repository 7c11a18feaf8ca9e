"""Data and spatial parallelism over ``torch.distributed`` (counterpart of
the JAX package's ``parallel/mesh.py``).

One process a GPU, as ``torchrun`` starts them. :func:`init_distributed`
joins the process group that ``torchrun``'s environment describes and is a
no-op without it. :func:`make_mesh` names the ``dp`` and ``sp`` axes over
the group's ranks, in JAX's order: the ranks reshaped row-major to the
spec's axes (``"dp=2,sp=2"``: rank = 2 dp + sp), with a sub-group along
each axis. A rank serves or trains its rows of each global batch
(:func:`batch_rows`, :func:`shard_batch`, by its ``dp`` coordinate,
replicated over ``sp``), and the collectives here make the ranks agree:

- :func:`gather_rows` gives every rank the whole batch in order (over the
  rank's ``dp`` sub-group), the counterpart of the global array that JAX
  hands back; :func:`gather_image_rows` the whole image from each rank's
  image rows (over every rank);
- :func:`all_reduce_mean` averages tensors over the ranks (the gradients,
  the metrics: JAX's ``lax.pmean``);
- :func:`replicate` broadcasts rank 0's tensors.

Spatial sharding (JAX ``shard_spatial``, ``spatial_shardable``): image rows
split evenly over the ranks that share an image, every rank for the serve
(:func:`shard_spatial`), the rank's ``sp`` sub-group for training.
:func:`row_split` installs that group as the models' row hook
(``ops/rowsplit.py``) for a call, so that their convs exchange halo rows
and their norms add their sums over it, forward and backward.

Only ``broadcast``, ``all_reduce`` and ``barrier`` are used, the
collectives that gloo also runs on CUDA tensors (and
:func:`broadcast_object` of a checkpoint, through host memory), so the same helpers serve
NCCL, gloo on the CPU and gloo on the card. A gather, and a halo exchange,
is an ``all_reduce`` (sum) of a zero-filled buffer that holds each rank's
rows: every element is its rank's value plus zeros, so the result is exact.

Without a process group, or in a world of 1, every helper is the identity
and runs no collective.

A batch that ``dp`` does not divide is served whole on every rank of a dp
row (``shard_batch``'s replication, with JAX's warning), unless the serve
splits its image rows (``inference.py``). A mesh with an axis other than
``dp`` and ``sp`` of size > 1 raises. JAX's ``batch_spec`` and
``replicated_spec`` name ``jit`` shardings and have no counterpart.

Randomness that JAX draws for the global batch is drawn here for the global
batch too, on every rank from the same seed, and sliced to the rank's rows
(and image rows), so that images and updates do not depend on the world
size: the serve wraps its noise so (``inference.py``), the trainer its
generator (``utils/draws.py:RowDraws``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from dgm_img_super_resolution_tpu_torch.ops import rowsplit
from dgm_img_super_resolution_tpu_torch.utils.misc import _map

logger = logging.getLogger("dgm_img_super_resolution_tpu_torch.parallel")

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT_S = 600.0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_world() -> int:
    """Ranks on this host (``torchrun``'s ``LOCAL_WORLD_SIZE``; 1 without it)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def local_cuda_device(backend: str | None = None) -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK``. More ranks than cards on a host
    is allowed under gloo only (NCCL refuses two ranks on one card): the
    ranks then share the cards in turn. ``backend``: the group's by default."""
    n, lr = torch.cuda.device_count(), local_rank()
    if lr < n:
        return torch.device("cuda", lr)
    backend = backend or (dist.get_backend() if dist.is_initialized() else None)
    if backend != "gloo" or n == 0:
        raise RuntimeError(f"local rank {lr} has no CUDA device ({n} visible) under {backend}")
    return torch.device("cuda", lr % n)


def init_distributed(backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); return True once it is joined. Without that
    environment it is a no-op that returns False, so entry points call it
    first and run alike on one process and under ``torchrun``.

    The backend is NCCL where CUDA is available, else gloo, or the one the
    caller names. The CUDA device is set to ``LOCAL_RANK`` first. A
    collective that waits longer than ``timeout_s`` fails. Idempotent."""
    if dist.is_initialized():
        return True
    if any(k not in os.environ for k in TORCHRUN_ENV):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if torch.cuda.is_available():
        dev = local_cuda_device(backend)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev  # NCCL's communicator binds the rank's card
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    logger.info("init_distributed: rank %d/%d (%s)", dist.get_rank(), dist.get_world_size(), backend)
    return True


def parse_mesh_shape(spec: str, n_devices: int) -> dict[str, int]:
    """Parse ``"dp=4,sp=2"`` into an axis dict; ``""`` -> every rank on dp."""
    if not spec:
        return {"dp": n_devices}
    axes: dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.strip().partition("=")
        axes[name] = int(size)
    total = math.prod(axes.values())
    if total != n_devices:
        raise ValueError(f"mesh {spec!r} needs {total} devices, have {n_devices}")
    return axes


@dataclasses.dataclass
class Mesh:
    """The axes over the process group's ranks, this rank's index and the
    group: None without ``torch.distributed``, where every collective is
    the identity. ``dp_group`` and ``sp_group``: the ranks along each axis
    that share this rank's other coordinates (the whole group when the
    other axes are 1; None where the axis is 1)."""

    shape: dict[str, int]
    rank: int
    group: Any = None
    dp_group: Any = None
    sp_group: Any = None

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp(self) -> int:
        """The ranks that split a batch."""
        return self.shape.get("dp", 1)

    @property
    def sp(self) -> int:
        """The ranks that split a training image's rows."""
        return self.shape.get("sp", 1)

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index on each axis: the ranks reshaped row-major to
        ``shape``, as JAX reshapes its devices."""
        return {k: int(i) for k, i in zip(self.shape, np.unravel_index(self.rank, tuple(self.shape.values())))}

    @property
    def dp_rank(self) -> int:
        return self.coords.get("dp", 0)

    @property
    def sp_rank(self) -> int:
        return self.coords.get("sp", 0)

    @property
    def device(self) -> torch.device:
        """Where the helpers put what they build: the card under NCCL."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return local_cuda_device()
        return torch.device("cpu")


def _axis_groups(shape: dict[str, int], axis: str) -> list[list[int]]:
    """The rank lists along ``axis``, one for each value of the others."""
    grid = np.arange(math.prod(shape.values())).reshape(tuple(shape.values()))
    grid = np.moveaxis(grid, list(shape).index(axis), -1)
    return grid.reshape(-1, shape[axis]).tolist()


def make_mesh(spec: str = "") -> Mesh:
    """The mesh of ``spec`` (``hp['mesh_shape']``) over the ranks of the
    process group (1 without one). ``dp`` and ``sp`` are ported: another
    axis of size > 1 raises rather than being folded into them. Every rank
    makes the sub-groups of both axes, in one order (``dist.new_group`` is
    collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = parse_mesh_shape(spec, world)
    other = {k: v for k, v in shape.items() if k not in ("dp", "sp") and v > 1}
    if other:
        raise NotImplementedError(
            f"mesh {spec!r}: the dp and sp axes are ported; {other} is not (ROADMAP.md)")
    if not dist.is_initialized():
        return Mesh(shape, 0)
    mesh = Mesh(shape, dist.get_rank(), dist.group.WORLD)
    for axis in ("dp", "sp"):
        size = shape.get(axis, 1)
        if size == 1:
            continue
        if size == world:
            setattr(mesh, f"{axis}_group", mesh.group)
            continue
        for ranks in _axis_groups(shape, axis):
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                setattr(mesh, f"{axis}_group", g)
    return mesh


def default_mesh(mesh: Mesh | None) -> Mesh:
    return mesh if mesh is not None else make_mesh()


class Rows(NamedTuple):
    """Rows [start, stop) of a global batch of ``total``: one rank's share."""

    start: int
    stop: int
    total: int

    @property
    def split(self) -> bool:
        """True when the rows are a part of the batch, not all of it."""
        return self.stop - self.start < self.total

    def take(self, x, dim: int = 0):
        """This share of a tensor or array whose dim ``dim`` is the whole."""
        if not self.split:
            return x
        return x[(slice(None),) * dim + (slice(self.start, self.stop),)]


class Shard(NamedTuple):
    """A rank's ``rows`` of a global batch and its ``data`` (a tree of those
    rows), as a loader given a mesh yields it."""

    data: Any
    rows: Rows


def even_rows(n: int, index: int, size: int) -> Rows:
    """Run ``index`` of ``n`` rows split evenly, in order, over ``size``."""
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over {size} ranks")
    per = n // size
    return Rows(index * per, (index + 1) * per, n)


def batch_rows(n: int, mesh: Mesh | None = None) -> Rows:
    """This rank's rows of a global batch of ``n``, by its ``dp``
    coordinate: all of them when ``dp`` does not divide ``n`` (JAX's
    replication rule)."""
    mesh = default_mesh(mesh)
    if n % mesh.dp:
        return Rows(0, n, n)
    return even_rows(n, mesh.dp_rank, mesh.dp)


def spatial_shardable(h: int, mesh: Mesh | None = None) -> bool:
    """JAX's rule for splitting ``h`` rows over the whole mesh: more than 1
    rank, the rows divide evenly, and at least 2 rows a rank."""
    n = default_mesh(mesh).world
    return n > 1 and h % n == 0 and h // n >= 2


def shard_spatial(h: int, mesh: Mesh | None = None) -> Rows:
    """This rank's rows of an image of ``h`` rows, split over every rank
    (JAX's ``shard_spatial``: the serve's layout). The rows must divide."""
    mesh = default_mesh(mesh)
    return even_rows(h, mesh.rank, mesh.world)


def _leading(a) -> int | None:
    shape = getattr(a, "shape", None)
    return int(shape[0]) if shape is not None and len(shape) >= 1 else None


def shard_batch(x: Any, mesh: Mesh | None = None) -> Any:
    """This rank's rows of a tree of arrays or tensors with a leading batch
    dim. A leaf that ``dp`` does not divide (a single image on two ranks) is
    returned whole on every rank, with a warning: correct, not parallel."""
    mesh = default_mesh(mesh)
    n_axis = mesh.dp

    def put(a):
        n = _leading(a)
        if n is None:
            return a
        if n % n_axis and n_axis > 1:
            # loud, not silent: N ranks quietly doing one rank's work is otherwise invisible
            logger.warning("shard_batch: leading dim %s not divisible by dp=%d — "
                           "replicating instead of sharding (serialised work)",
                           tuple(a.shape), n_axis)
        return batch_rows(n, mesh).take(a)

    return _map(put, x)


# ------------------------------------------------------------- collectives
def _active(mesh: Mesh | None) -> Mesh | None:
    """The mesh when a collective has work to do: a group of 2 or more."""
    mesh = default_mesh(mesh)
    return mesh if mesh.group is not None and mesh.world > 1 else None


def _coalesced(tensors: list[torch.Tensor], collective: Callable[[torch.Tensor], None]) -> None:
    """Run ``collective`` in place over ``tensors``, one flat buffer per
    (device, dtype)."""
    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        collective(flat)
        off = 0
        for t in ts:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[off: off + n].view_as(t))
            off += n


def all_reduce_mean(tensors: list[torch.Tensor], mesh: Mesh | None = None) -> list[torch.Tensor]:
    """Average ``tensors`` in place over the ranks (a sum, then / world:
    gloo has no average)."""
    m = _active(mesh)
    if m is None or not tensors:
        return tensors

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=m.group)
        flat.div_(m.world)

    _coalesced(tensors, mean)
    return tensors


def replicate(x: Any, mesh: Mesh | None = None) -> Any:
    """Rank 0's values of the tensors of a tree, and of the parameters and
    buffers of the modules in it, on every rank (in place); returns ``x``."""
    m = _active(mesh)
    if m is None:
        return x
    tensors: list[torch.Tensor] = []

    def add(v):
        if isinstance(v, torch.nn.Module):
            tensors.extend(v.state_dict(keep_vars=True).values())
        elif isinstance(v, torch.Tensor):
            tensors.append(v)

    _map(add, x)
    _coalesced([t for t in tensors if t.numel()],
               lambda flat: dist.broadcast(flat, src=0, group=m.group))
    return x


def _gather(x: torch.Tensor, rows: Rows, dim: int, group) -> torch.Tensor:
    """The whole along ``dim`` from each member's ``rows`` of it: an exact
    ``all_reduce`` sum of a zero-filled buffer over ``group``."""
    shape = list(x.shape)
    shape[dim] = rows.total
    out = x.new_zeros(shape)
    out[(slice(None),) * dim + (slice(rows.start, rows.stop),)] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def gather_rows(x: torch.Tensor, rows: Rows, mesh: Mesh | None = None) -> torch.Tensor:
    """The global batch from each rank's ``rows`` of it, in order, on every
    rank (over the rank's ``dp`` sub-group: the ``sp`` ranks of a dp row
    hold the same rows)."""
    m = _active(mesh)
    if m is None or not rows.split:
        return x
    return _gather(x, rows, 0, m.dp_group)


def gather_image_rows(x: torch.Tensor, rows: Rows, mesh: Mesh | None = None) -> torch.Tensor:
    """The whole NCHW image from each rank's ``rows`` of it, split over
    every rank as :func:`shard_spatial` splits it."""
    m = _active(mesh)
    if m is None or not rows.split:
        return x
    return _gather(x, rows, 2, m.group)


class _DistRows(rowsplit.RowGroup):
    """A row group over a ``torch.distributed`` group."""

    def __init__(self, group, index: int, size: int):
        super().__init__(index, size)
        self.group = group

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=self.group)


def row_split(mesh: Mesh | None = None, axis: str | None = None, trace: list | None = None) -> rowsplit.split:
    """A context under which the models split image rows evenly over every
    rank (``axis`` None: the serve's split, as :func:`shard_spatial`) or
    over the rank's ``axis`` sub-group (``"sp"``: the training step's).
    ``trace``: a list that records each collective of the split
    (``ops/rowsplit.py``)."""
    mesh = default_mesh(mesh)
    if axis is None:
        group, index, size = mesh.group, mesh.rank, mesh.world
    else:
        group, index, size = getattr(mesh, f"{axis}_group"), mesh.coords.get(axis, 0), mesh.shape.get(axis, 1)
    if size < 2 or group is None:
        raise ValueError(f"a row split needs a group of 2 or more ranks, not {size} on mesh {mesh.shape}")
    return rowsplit.split(_DistRows(group, index, size), trace)


def broadcast_object(obj: Any, mesh: Mesh | None = None) -> Any:
    """Rank 0's ``obj`` (any picklable tree, tensors included) on every
    rank; the others' ``obj`` is ignored."""
    m = _active(mesh)
    if m is None:
        return obj
    box = [obj if m.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=m.group)
    return box[0]


def barrier(mesh: Mesh | None = None) -> None:
    m = _active(mesh)
    if m is not None:
        dist.barrier(group=m.group)


def is_main(mesh: Mesh | None = None) -> bool:
    """True on rank 0 (and without a process group)."""
    return default_mesh(mesh).rank == 0
