"""The one traffic generator: a closed-loop client with requests in flight.

The client makes request ``i``'s inputs from the seed (``driver.request``),
calls the entry (``driver.call``, which returns once the work is enqueued),
and keeps up to ``in_flight`` calls outstanding before it fetches the oldest
to the host (``driver.fetch``). With ``in_flight`` 1 each request waits for
the one before it, the way a user waits for an image; with 2 the next call
is enqueued while the last one runs, the way a batch server overlaps a
copy to the host with the next compute.

The measured window opens at the first call and closes at the first fetch
that completes ``seconds`` or more after it; its length is that fetch's
time less the opening, and it counts every request fetched by then. The
calls still in flight at the close are fetched after it: they count as
attempted and are judged for ``correct``, not timed.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    t_call: float
    t_return: float
    t_fetched: float = float("nan")
    output: object = None
    error: str | None = None


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    timed: list          # fetched inside the window
    late: list           # in flight at the close, fetched after it

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    @property
    def attempted(self) -> list:
        return self.timed + self.late


def request_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed for request ``index`` of run ``seed`` (any whole
    numbers; warm-up requests take indices of their own)."""
    entropy = [int(seed) % (1 << 64), int(stream), int(index) % (1 << 64)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _range(annotate: bool, name: str):
    if not annotate:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def run(driver, seed: int, in_flight: int, first: int = 0, seconds: float | None = None,
        count: int | None = None, annotate: bool = False) -> Window:
    """Drive requests ``first``, ``first + 1``, ... until the window closes
    (``seconds`` after the first call, or after ``count`` requests)."""
    pending: collections.deque[Request] = collections.deque()
    timed: list[Request] = []
    index = first
    t_open = time.perf_counter()
    deadline = t_open + seconds if seconds is not None else float("inf")
    t_close = None
    while t_close is None:
        while len(pending) < in_flight and (count is None or index - first < count):
            with _range(annotate, "bench.inputs"):
                inputs = driver.request(seed, index)
            with _range(annotate, "bench.call"):
                t_call = time.perf_counter()
                req = Request(index, t_call, t_call)
                try:
                    req.output = driver.call(inputs)
                except Exception as exc:  # a failed request counts as failed, and the run goes on
                    req.error = f"call: {type(exc).__name__}: {exc}"
                req.t_return = time.perf_counter()
            pending.append(req)
            index += 1
        req = pending.popleft()
        with _range(annotate, "bench.fetch"):
            _fetch(driver, req)
        timed.append(req)
        if req.t_fetched >= deadline or (count is not None and index - first >= count and not pending):
            t_close = req.t_fetched
    late = []
    while pending:
        req = pending.popleft()
        _fetch(driver, req)
        late.append(req)
    return Window(t_open, t_close, timed, late)


def _fetch(driver, req: Request) -> None:
    if req.error is None:
        try:
            req.output = driver.fetch(req.output)
        except Exception as exc:
            req.error = f"fetch: {type(exc).__name__}: {exc}"
            req.output = None
    req.t_fetched = time.perf_counter()
