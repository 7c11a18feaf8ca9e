"""Captured CUDA graphs: the port's counterpart of the JAX package's compile
boundaries (``inference.py:93 SRDiffPipeline._sample_fn``,
``models/sd/pipeline.py:172 _denoise_segment``, ``train/trainer.py:138
Trainer.compile_step``, ``train/tasks/gan.py:228 GANTask.jitted_step``).

JAX compiles each of those calls into one program per shape; PyTorch runs
eagerly, one Python launch at a time. A :class:`GraphCache` holds, per call
key (the shapes and static arguments of the call), one captured
``torch.cuda.CUDAGraph`` with its static inputs and its static outputs;
at most ``MAXSIZE`` (8) entries, the least recently used evicted first, as
JAX's ``lru_cache(maxsize=8)``. A cache's graphs capture into one memory
pool: they replay one at a time on one stream and their outputs are cloned
at once, so one graph's intermediates may lie where another's were.

- The first call of a key runs the function eagerly on a side stream: the
  warm-up PyTorch's docs ask for before a capture, and that call's result.
  Then the function is captured once (capture runs nothing on the device).
  Every later call copies its inputs into the static ones, replays, and
  returns clones of the static outputs, so that a result outlives the next
  call.
- Generators. An entry owns a generator registered with its graph
  (``CUDAGraph.register_generator_state``); the function draws from it.
  A call copies its own generator's state in before the replay and the
  advanced state back after it, so each replay draws what an eager call
  from the same state draws, and leaves the generator where an eager call
  leaves it, whichever generator object the call brings.
- Launch counters. A kernel wrapper counts its launches on the host
  (``launches``, ``launches_wgmma``, ``launches_by_shape``, ... in
  ``ops/kernels/*.py``) and registers itself here (:func:`register_counters`,
  through ``ops/kernels/_common.py:counted``). The warm-up's launches are
  real and count. The capture only records: the counts it made are taken
  back and kept on the entry as its deltas, and every replay adds them once.
- The key also holds the TF32 switches and cuDNN's ``deterministic`` and
  ``benchmark``, which choose the kernels a capture records; the callers put
  the port's kernel routing (``models/layers.py:routing_key``) in theirs.
- :func:`eager` is the counterpart of ``jax.disable_jit()``: inside it,
  every captured path runs eagerly on the card, as on the CPU.
- No fallback: a capture or a replay that fails raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

MAXSIZE = 8
_EAGER = False


@contextlib.contextmanager
def eager():
    """Run every captured path eagerly inside this context (on the card
    too), as ``jax.disable_jit()`` does. Re-entrant."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def enabled(device: torch.device) -> bool:
    """Whether a call on ``device`` goes through a captured graph: on a
    CUDA device, outside :func:`eager`."""
    return torch.device(device).type == "cuda" and not _EAGER


def routing() -> tuple:
    """The torch settings that choose the kernels a capture records: TF32
    and cuDNN's choice of algorithms."""
    cudnn = torch.backends.cudnn
    return (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            cudnn.deterministic, cudnn.benchmark)


# ------------------------------------------------------------ launch counters
_COUNTED: list[Callable] = []


def register_counters(fn: Callable) -> Callable:
    """Register a kernel wrapper whose ``launches*`` attributes count its
    launches, so that a replay adds what its capture counted."""
    if fn not in _COUNTED:
        _COUNTED.append(fn)
    return fn


def counts() -> dict:
    """Every registered wrapper's launch counters: ``{(wrapper, attribute):
    int or dict}``, dicts copied."""
    out = {}
    for fn in _COUNTED:
        for attr, v in vars(fn).items():
            if attr.startswith("launches"):
                out[fn, attr] = dict(v) if isinstance(v, dict) else int(v)
    return out


def count_deltas(before: dict, after: dict) -> dict:
    """What the counters gained from ``before`` to ``after``, the zero ones
    left out."""
    out = {}
    for key, v in after.items():
        if isinstance(v, dict):
            d = {k: n - before[key].get(k, 0) for k, n in v.items() if n != before[key].get(k, 0)}
        else:
            d = v - before[key]
        if d:
            out[key] = d
    return out


def set_counts(values: dict) -> None:
    """Put the counters back to ``values`` (a dict counter in place)."""
    for (fn, attr), v in values.items():
        if isinstance(v, dict):
            getattr(fn, attr).clear()
            getattr(fn, attr).update(v)
        else:
            setattr(fn, attr, v)


def add_counts(deltas: dict) -> None:
    """Add ``deltas`` to the counters: what one replay launched."""
    for (fn, attr), d in deltas.items():
        if isinstance(d, dict):
            cur = getattr(fn, attr)
            for k, n in d.items():
                cur[k] = cur.get(k, 0) + n
        else:
            setattr(fn, attr, getattr(fn, attr) + d)


# -------------------------------------------------------------------- trees
def tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tensor, tuple, list or dict of them
    (``None`` and other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------- the cache
@dataclasses.dataclass
class Entry:
    """One captured call: its graph, its static inputs and outputs, the
    generator registered with it, the launches one replay makes, and what
    its capture cost."""

    graph: Any
    inputs: dict[str, torch.Tensor]
    outputs: Any
    generator: torch.Generator | None
    deltas: dict
    capture_s: float = 0.0
    pool_bytes: int = 0

    def replay(self, inputs: dict[str, torch.Tensor], generator: torch.Generator | None):
        """Copy ``inputs`` in, replay with ``generator``'s state, add the
        launches; clones of the static outputs."""
        if inputs.keys() != self.inputs.keys():
            raise KeyError(f"graph inputs {sorted(inputs)}, captured with {sorted(self.inputs)}")
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        self.graph.replay()
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        add_counts(self.deltas)
        return tree_map(torch.Tensor.clone, self.outputs)


class GraphCache:
    """Captured graphs by call key, at most ``MAXSIZE``, the least recently
    used evicted first."""

    def __init__(self):
        self.entries: collections.OrderedDict[Any, Entry] = collections.OrderedDict()
        self.pool = None  # the memory pool the graphs share, taken at the first capture

    def __len__(self) -> int:
        return len(self.entries)

    def clear(self) -> None:
        """Drop every graph; the next capture takes a new pool (a pool that
        no graph holds any more cannot be shared)."""
        self.entries.clear()
        self.pool = None

    def run(self, key, fn: Callable, inputs: dict[str, torch.Tensor], generator: torch.Generator | None = None):
        """``fn(inputs, generator)`` -> a tensor or a tuple / list / dict of
        them, through the graph of ``key``: captured after an eager first
        call, replayed after. ``generator`` (when the function draws) is the
        call's own; the function is handed the entry's."""
        key = (key, generator is None, routing())
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            return entry.replay(inputs, generator)
        if self.pool is None and torch.cuda.is_available():
            self.pool = torch.cuda.graph_pool_handle()
        out, entry = self._capture(fn, inputs, generator, self.pool)
        self.entries[key] = entry
        while len(self.entries) > MAXSIZE:
            self.entries.popitem(last=False)
        return out

    @staticmethod
    def _capture(fn: Callable, inputs: dict[str, torch.Tensor], generator: torch.Generator | None, pool):
        """(the eager first call's result, the entry captured after it into
        ``pool``). The static inputs live on the card, whichever device a
        call's input comes from (a hook's tensors may lie on the host); the
        entry's ``pool_bytes`` is what the capture added to the pool."""
        dev = torch.device("cuda", torch.cuda.current_device())
        static = {k: torch.empty_like(v, device=dev).copy_(v) for k, v in inputs.items()}
        gen = None
        if generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(generator.get_state())
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(static, gen)
        main.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(main)
        if generator is not None:
            generator.set_state(gen.get_state())
        warm = counts()
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as the capture does first: the pool's segments are what reserved gains
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            outputs = fn(static, gen)
        capture_s = time.perf_counter() - t0
        deltas = count_deltas(warm, counts())
        set_counts(warm)  # the capture launched nothing
        entry = Entry(graph, static, outputs, gen, deltas, capture_s, torch.cuda.memory_reserved() - reserved)
        return out, entry


def tensor_inputs(prefix: str, value) -> dict[str, torch.Tensor] | None:
    """A tensor, or a tuple / list / dict of tensors (nested), as static
    inputs named under ``prefix``; None when anything in it is not a
    tensor (a callable noise hook), which keeps the call eager."""
    if isinstance(value, torch.Tensor):
        return {prefix: value}
    if isinstance(value, (tuple, list)):
        items = enumerate(value)
    elif isinstance(value, dict):
        items = value.items()
    else:
        return None
    out = {}
    for k, v in items:
        sub = tensor_inputs(f"{prefix}.{k!r}", v)
        if sub is None:
            return None
        out.update(sub)
    return out


def rebuild(prefix: str, like, static: dict[str, torch.Tensor]):
    """``like`` (as :func:`tensor_inputs` took it) with each tensor replaced
    by its static input."""
    if isinstance(like, torch.Tensor):
        return static[prefix]
    if isinstance(like, dict):
        return {k: rebuild(f"{prefix}.{k!r}", v, static) for k, v in like.items()}
    return type(like)(rebuild(f"{prefix}.{k!r}", v, static) for k, v in enumerate(like))


def signature(value):
    """The shapes and dtypes of a tree of tensors, for a key."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.dtype
    if isinstance(value, dict):
        return tuple((k, signature(v)) for k, v in value.items())
    if isinstance(value, (tuple, list)):
        return tuple(signature(v) for v in value)
    return value
