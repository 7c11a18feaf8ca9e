"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells, the
configurations and the metrics. Everything that belongs to one of them
sits in a file of its own under ``benchmark/``:

- a configuration: ``configs/<config>.json`` (widths, dtype, the sampler's
  operating point, ``reduced``, ``assumed``, and ``driver``, the name of
  the module under ``drivers/`` that serves it);
- a traffic mix: ``traffic/<traffic>.json`` (batch, LR size, requests in
  flight, prompts, the requests the traced run profiles);
- a cell: ``workloads/<cell>.json`` (its configuration and traffic by
  name, and the comparison that decides ``correct``: the requests sampled
  and each number's limit);
- a per-layer metric: ``metrics/<metric>.py`` with ``read(record)`` (for a
  split name such as ``mfu.latency``, the part before the dot);
- a kernel's work count: ``roofline/<kernel>.py`` with ``work(...)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config_file(name: str) -> Path:
    return BENCH_DIR / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def workload_file(name: str) -> Path:
    return BENCH_DIR / "workloads" / f"{name}.json"


def metric_module(name: str):
    """The reader of ``name``: ``metrics/<name>.py``, where the name's part
    before its first dot names the file, so that one quantity split by the
    end-to-end metric it moves (``host_call_ms.latency``) has one reader."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}")


def roofline_module(kernel: str):
    return importlib.import_module(f"benchmark.roofline.{kernel}")


def driver_module(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


@dataclasses.dataclass
class Cell:
    """One cell with everything it names, resolved."""

    name: str
    entry: dict          # its line in BENCHMARK.json
    workload: dict       # workloads/<cell>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # the end-to-end metrics it reports
    per_layer: list      # the per-layer metrics read in its traced run


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files; raises
    ``KeyError`` for a cell the file does not list."""
    bench = bench if bench is not None else benchmark_json()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    workload = load_json(workload_file(name))
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{workload_file(name)} names {workload['config']}/{workload['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in moved and _reports(m, name)]
    return Cell(name, entry, workload, load_json(config_file(entry["config"])),
                load_json(traffic_file(entry["traffic"])), e2e, per_layer)
