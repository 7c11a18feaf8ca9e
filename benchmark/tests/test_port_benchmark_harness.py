"""The benchmark's data and harness on the CPU: every name resolves to its
file, the result's line has the contract's keys, a run without a card
prints no result, and the plain references agree with the port's plain
CPU path at tiny widths.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark.harness import core, spec
from benchmark.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]


def test_benchmark_json_has_the_contracts_keys_and_names():
    assert list(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]:
        assert spec.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    assert c.entry["chips"] == 1
    assert spec.workload_file(cell).exists() and spec.traffic_file(c.entry["traffic"]).exists()
    assert c.workload["check"]["limits"] and int(c.workload["check"]["sample"]) >= 1
    assert spec.driver_module(c.config["driver"]).Driver
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"


def test_every_config_resolves_to_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path == spec.config_file(c["name"]) and path.exists()
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert c["name"] in used


def test_every_per_layer_metric_resolves_to_its_reader():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_module(m["name"]).read)
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in CELLS
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _last_line(cell, traced):
    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    result = core.run_cell(cell, 2**33 + 17, 0.2, traced, "cpu", time.perf_counter())
    line, notes = run.emit(result)
    return json.loads(line), notes


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_contracts_keys(traced):
    out, notes = _last_line(tiny_cell("srdiff_b1_lr128"), traced)
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["check"]
    assert list(out) == want
    assert isinstance(out["correct"], bool) and out["attempted"] >= 1 and out["failed"] == 0
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["check"]) == set(tiny_cell("srdiff_b1_lr128").workload["check"]["limits"])
    assert notes[-1].startswith("check ")
    if traced:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert set(out["metrics"]) == {"latency_p95_s", "setup_s"}


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", str(2**33 + 1),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_with_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell,most", [("srdiff_b8_lr128", 0.5 + 1e-3), ("sd_b1_lr256", 0.02)])
def test_reference_matches_the_ports_plain_path_in_float32(cell, most):
    """Float32 on both sides (the port's kernels run their plain versions
    on the CPU): SRDiff's uint8 output lies within its rounding of the
    reference's float image, SD's float image within float32 sum order."""
    c = tiny_cell(cell)
    c.config["dtype"] = "float32"
    r = core.run_cell(c, 2**35 + 3, 0.1, False, "cpu", time.perf_counter())
    assert r["failed"] == 0
    assert r["_check"]["numbers"]["max_abs"] <= most, r["_check"]["numbers"]
