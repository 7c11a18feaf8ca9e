"""The traced run's device record, read from ``torch.profiler``'s events.

The benchmark profiles a short run of requests after its measured window,
with its own host ranges around each step of the client (``bench.inputs``,
``bench.call``, ``bench.fetch``) and one around the whole traced run
(``bench.window``). Graph replays carry no host ranges of the program, so
the device record is the kernels, copies and fills that CUPTI reports, by
name, start and duration, on the profiler's clock, the same clock as the
host ranges.
"""

from __future__ import annotations

import dataclasses

WINDOW = "bench.window"
HOST_RANGES = ("bench.inputs", "bench.call", "bench.fetch")


def kernel_class(name: str) -> str:
    """The profile tool's classes of device work (``tools/torch_port_profile.py``)."""
    if any(k in name for k in ("conv_tile_kernel", "conv_wgmma_kernel", "stem_kernel", "h1_kernel",
                               "conv_stream_kernel", "chain_wide_kernel", "conv_wide_kernel", "convt_kernel",
                               "ds_kernel", "head_kernel")):
        return "port_regions"
    if "flash_kernel" in name:
        return "port_flash"
    if name.startswith("gn_") or "gn_stats" in name or "gn_apply" in name:
        return "port_group_norm"
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "glue"
    if any(k in low for k in ("xmma", "implicit_gemm", "cudnn", "cutlass", "conv", "gemm", "sm90")):
        return "library"
    return "glue"


@dataclasses.dataclass
class DeviceRecord:
    """What one traced run left: device events ``(name, start_ns, end_ns)``
    and host ranges ``(name, start_ns, end_ns)`` inside the traced window
    ``[start_ns, end_ns]``."""

    start_ns: int
    end_ns: int
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device events' intervals, clipped to the window."""
        spans = sorted((max(s, self.start_ns), min(e, self.end_ns)) for _, s, e in self.device)
        out: list[list[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_by(self, key) -> dict[str, float]:
        """Device seconds (summed durations) by ``key(name)``."""
        out: dict[str, float] = {}
        for name, s, e in self.device:
            k = key(name)
            out[k] = out.get(k, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Every idle gap of the device inside the window, longest first,
        named by the benchmark's host range that held its start."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [v for iv in busy for v in iv] + [self.end_ns]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
        out = []
        for g0, g1 in gaps:
            held = [n for n, s, e in self.host if s <= g0 < e]
            out.append((held[-1] if held else "host: between the client's steps", (g1 - g0) / 1e9))
        return sorted(out, key=lambda x: -x[1])


def from_profiler(prof) -> DeviceRecord:
    """The record of a finished ``torch.profiler.profile``: its raw events,
    without building the per-op tree."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window, host, device = None, [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                rng = (name, e.start_ns(), e.start_ns() + e.duration_ns())
                if name == WINDOW:
                    window = rng
                elif name in HOST_RANGES:
                    host.append(rng)
            continue
        if e.is_user_annotation() or e.duration_ns() <= 0:
            continue  # the host ranges' shadows on the device timeline
        device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window[1], window[2]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    return DeviceRecord(w0, w1, inside, sorted(host, key=lambda r: r[1]))
