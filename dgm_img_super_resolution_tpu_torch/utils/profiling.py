"""Tracing and profiling hooks (counterpart of the JAX package's
``utils/profiling.py``).

``trace_annotation`` names a region in a ``torch.profiler`` trace (and, on
the card, as an NVTX range for a system profiler); ``profile_to`` captures a
``torch.profiler`` trace of the enclosed region into a TensorBoard log dir;
``StepTimer`` gives steps per second and the median step time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Named region in the profiler's trace; an NVTX range too when CUDA is up."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the enclosed region (CPU, and
    CUDA when there is a device) into ``log_dir`` for TensorBoard."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield prof


class StepTimer:
    """Steps/sec + p50 latency over a sliding window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    @property
    def p50_latency(self) -> float:
        if not self._times:
            return 0.0
        return sorted(self._times)[len(self._times) // 2]
