"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``).

One process a GPU, as ``torchrun`` starts them. :func:`init_distributed`
joins the process group that ``torchrun``'s environment describes and is a
no-op without it. :func:`make_mesh` names the ``dp`` axis over the group's
ranks; a rank serves or trains its rows of each global batch
(:func:`batch_rows`, :func:`shard_batch`), and the collectives here make
the ranks agree:

- :func:`gather_rows` gives every rank the whole batch in order, the
  counterpart of the global array that JAX hands back;
- :func:`all_reduce_mean` averages tensors over the ranks (the gradients,
  the metrics: JAX's ``lax.pmean``);
- :func:`replicate` broadcasts rank 0's tensors.

Only ``broadcast``, ``all_reduce`` and ``barrier`` are used, the
collectives that gloo also runs on CUDA tensors (and
:func:`broadcast_object` of a checkpoint, through host memory), so the same helpers serve
NCCL, gloo on the CPU and gloo on the card. The gather is an ``all_reduce``
(sum) of a zero-filled global buffer that holds each rank's rows: every
element is its rank's value plus zeros, so the result is exact.

Without a process group, or in a world of 1, every helper is the identity
and runs no collective.

A batch that the world does not divide is served whole on every rank
(``shard_batch``'s replication, with JAX's warning). Only ``dp`` is ported:
a mesh with ``sp`` (or any other axis) > 1 raises. JAX's ``batch_spec`` and
``replicated_spec`` name ``jit`` shardings and have no counterpart.

Randomness that JAX draws for the global batch is drawn here for the global
batch too, on every rank from the same seed, and sliced to the rank's rows,
so that images and updates do not depend on the world size: the serve
wraps its noise so (``inference.py``), the trainer its generator
(``utils/draws.py:RowDraws``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

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
    """The ``dp`` axis over the process group's ranks, this rank's index on
    it and the group: None without ``torch.distributed``, where every
    collective is the identity."""

    shape: dict[str, int]
    rank: int
    group: Any = None

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp(self) -> int:
        """The ranks that split a batch."""
        return self.shape.get("dp", 1)

    @property
    def device(self) -> torch.device:
        """Where the helpers put what they build: the card under NCCL."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return local_cuda_device()
        return torch.device("cpu")


def make_mesh(spec: str = "") -> Mesh:
    """The mesh of ``spec`` (``hp['mesh_shape']``) over the ranks of the
    process group (1 without one). Only ``dp`` is ported: another axis of
    size > 1 raises rather than being folded into ``dp``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = parse_mesh_shape(spec, world)
    other = {k: v for k, v in shape.items() if k != "dp" and v > 1}
    if other:
        raise NotImplementedError(
            f"mesh {spec!r}: only the dp axis is ported; {other} waits for spatial sharding "
            "(ROADMAP.md, queue A: sp)")
    if not dist.is_initialized():
        return Mesh(shape, 0)
    return Mesh(shape, dist.get_rank(), dist.group.WORLD)


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

    def take(self, x):
        """This share of a tensor or array whose leading dim is the global batch."""
        return x[self.start:self.stop] if self.split else x


class Shard(NamedTuple):
    """A rank's ``rows`` of a global batch and its ``data`` (a tree of those
    rows), as a loader given a mesh yields it."""

    data: Any
    rows: Rows


def batch_rows(n: int, mesh: Mesh | None = None) -> Rows:
    """This rank's rows of a global batch of ``n``: all of them when ``dp``
    does not divide ``n`` (JAX's replication rule)."""
    mesh = default_mesh(mesh)
    k = mesh.dp
    if n % k:
        return Rows(0, n, n)
    per = n // k
    return Rows(mesh.rank * per, (mesh.rank + 1) * per, n)


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


def gather_rows(x: torch.Tensor, rows: Rows, mesh: Mesh | None = None) -> torch.Tensor:
    """The global batch from each rank's ``rows`` of it, in order, on every
    rank: an exact ``all_reduce`` sum of a zero-filled global buffer."""
    m = _active(mesh)
    if m is None or not rows.split:
        return x
    out = x.new_zeros((rows.total,) + tuple(x.shape[1:]))
    out[rows.start:rows.stop] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=m.group)
    return out


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
