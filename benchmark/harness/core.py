"""One run of one cell: set-up, the measured window, the traced run, the
check against the plain reference, and the result's line.

``run_cell`` does not look for a card: ``run.py`` does that before it
calls it, and the tests call it on the CPU at tiny widths with the port's
plain versions.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.harness import check, client, spec, trace

BANNED = ("jax", "jaxlib", "flax", "dgm_img_super_resolution_tpu")


def banned_modules() -> list[str]:
    """Modules loaded in this process whose top-level name (the part before
    the first dot, compared whole) is JAX's, flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in BANNED})


@dataclasses.dataclass
class Record:
    """What a run measured, for the per-layer metrics' readers."""

    cell: spec.Cell
    driver: object
    window: client.Window
    images_per_request: int
    setup_s: float
    capture_s: float | None
    counts: dict                      # launch counters gained in the window, by "wrapper.attribute"
    peak_reserved: int | None
    device: trace.DeviceRecord | None = None
    traced: client.Window | None = None
    traced_counts: dict = dataclasses.field(default_factory=dict)
    flops: float | None = None        # FLOP of one request, counted on the reference

    @property
    def images(self) -> int:
        return self.images_per_request * len(self.window.timed)

    @property
    def traced_images(self) -> int:
        return self.images_per_request * len(self.traced.timed) if self.traced else 0

    def launches(self, kernels: tuple[str, ...]) -> list:
        """(kernel, shape, launches) of ``kernels`` in the traced run."""
        return [k for k in self.driver.launches(self.traced_counts) if k[0] in kernels]


def counters() -> dict:
    from dgm_img_super_resolution_tpu_torch.core import graphs

    return graphs.counts()


def named_deltas(before: dict, after: dict) -> dict:
    from dgm_img_super_resolution_tpu_torch.core import graphs

    return {f"{fn.__name__}.{attr}": v for (fn, attr), v in graphs.count_deltas(before, after).items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        info["card"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["card"] = "power limit not read"
    return info


def traced_run(drv, seed: int, in_flight: int, count: int, device: torch.device):
    """``count`` requests after the window under ``torch.profiler``: the
    device record, the window, the counters gained."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    before = counters()
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            win = client.run(drv, seed, in_flight, first=1 << 40, count=count, annotate=True)
            sync(device)
    return trace.from_profiler(prof), win, named_deltas(before, counters())


def reference_check(drv, cell: spec.Cell, seed: int, window: client.Window, device: torch.device) -> dict:
    """Draw the sampled requests from the seed out of those attempted, run
    the reference over each (its inputs made again from the seed, its
    weights drawn again), and judge the numbers against the cell's limits."""
    from benchmark.reference import precision as P

    chk = cell.workload["check"]
    shape, dtype = drv.expected()
    bad = [r for r in window.attempted if r.error is None and
           (tuple(r.output.shape) != tuple(shape) or r.output.dtype != dtype)]
    for r in bad:
        r.error = f"output {tuple(r.output.shape)} {r.output.dtype}, expected {tuple(shape)} {dtype}"
    good = [r for r in window.attempted if r.error is None]
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    k = min(int(chk["sample"]), len(good))
    sample = [good[i] for i in sorted(rng.choice(len(good), size=k, replace=False))] if k else []
    P.no_tf32()
    model = drv.reference_model("meta")
    model.load_state_dict({k: v.float() for k, v in _flat(drv.weights(seed)).items()}, strict=True, assign=True)
    model.eval()
    refs = [drv.reference(model, drv.request(seed, r.index)) for r in sample]
    numbers = check.image_numbers([r.output for r in sample], refs) if sample else {}
    judged = check.judge(numbers, chk["limits"]) if sample else []
    return {"numbers": numbers, "judged": judged, "sampled": [r.index for r in sample]}


def _flat(w: dict) -> dict:
    """A nested ``{part: {name: tensor}}`` as one state dict."""
    out = {}
    for k, v in w.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             driver_cls=None) -> dict:
    """One run of ``cell``: the result's line as a dict (its last key
    ``check``), with ``_record``, ``_check`` and ``_errors`` for the
    caller."""
    device = torch.device(device)
    traffic = cell.traffic
    cls = driver_cls or spec.driver_module(cell.config["driver"]).Driver
    drv = cls(cell.config, traffic, device)
    drv.build(seed)
    gc.collect()
    if device.type == "cuda":
        sync(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    for k in range(int(traffic["warmup"])):  # the first call captures the cell's shape; the next replay
        drv.fetch(drv.call(drv.request(seed, (1 << 41) + k)))
    sync(device)
    gc.collect()
    gc.freeze()  # set-up's objects out of every later collection's walk
    setup_s = time.perf_counter() - t_start

    before = counters()
    window = client.run(drv, seed, int(traffic["in_flight"]), seconds=seconds)
    counts = named_deltas(before, counters())
    rec = Record(cell, drv, window, drv.images_per_request, setup_s, drv.capture_s(), counts, None)
    if traced:
        rec.device, rec.traced, rec.traced_counts = traced_run(drv, seed, int(traffic["in_flight"]),
                                                               int(traffic["trace_requests"]), device)
    if device.type == "cuda":
        sync(device)
        rec.peak_reserved = int(torch.cuda.max_memory_reserved(device))
    dev = card(device)
    if rec.peak_reserved is not None:
        dev["memory_peak_bytes"] = rec.peak_reserved
    if traced and rec.device is not None:
        dev["busy_s"] = rec.device.busy_s()
        dev["window_s"] = rec.device.window_s

    drv.free()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result_check = reference_check(drv, cell, seed, window, device)
    failed = sum(r.error is not None for r in window.attempted)
    correct = failed == 0 and bool(result_check["judged"]) and all(j["ok"] for j in result_check["judged"])

    metrics = {}
    if traced:
        rec.flops = drv.flops_per_request()
        for m in cell.per_layer:
            value = spec.metric_module(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = end_to_end(rec)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(window.attempted), "failed": failed, "metrics": metrics,
           "device": dev}
    if traced and rec.device is not None:
        out["breakdown"] = breakdown(rec.device)
    out["check"] = {j["name"]: {"value": j["value"], "limit": j["limit"]} for j in result_check["judged"]}
    out["_record"], out["_check"] = rec, result_check
    errors = [r.error for r in window.attempted if r.error is not None]
    out["_errors"] = errors[:5]
    return out


def end_to_end(rec: Record) -> dict[str, float]:
    """The end-to-end metrics of a window: images whose bytes reached the
    host over the window's seconds, the 95th percentile of every request's
    time from its call to its image on the host, and the set-up."""
    lat = [r.t_fetched - r.t_call for r in rec.window.timed]
    return {"images_per_s": rec.images / rec.window.seconds,
            "latency_p95_s": float(np.percentile(lat, 95)) if lat else float("nan"),
            "setup_s": rec.setup_s}


def breakdown(dev: trace.DeviceRecord) -> dict:
    ops = sorted(dev.seconds_by(lambda n: n[:120]).items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in dev.idle_gaps()[:10]]}

