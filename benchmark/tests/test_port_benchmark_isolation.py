"""The benchmark measures the port alone: its harness, drivers and metric
readers import with JAX and the JAX package blocked, and the plain
reference imports nothing of the port. Top-level module names (the part
before the first dot) are compared whole: the port's name begins with the
JAX package's.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

BLOCKER = r"""
import importlib.abc, sys
BANNED = {"jax", "jaxlib", "flax", "dgm_img_super_resolution_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
"""


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)


def test_harness_drivers_and_metrics_import_with_jax_blocked():
    code = BLOCKER + r"""
import importlib, pkgutil, runpy
sys.path.insert(0, "benchmark")
import run  # benchmark/run.py
import benchmark.harness.core as core, benchmark.calibrate, benchmark.spread
for pkg in ("benchmark.drivers", "benchmark.roofline", "benchmark.harness", "benchmark.reference"):
    mod = importlib.import_module(pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(f"{pkg}.{info.name}")
from benchmark.harness import spec
for m in spec.benchmark_json()["per_layer"]:
    spec.metric_module(m["name"])
# the drivers build the port: its modules import too
for w in spec.benchmark_json()["workloads"]:
    cell = spec.resolve(w["name"])
    spec.driver_module(cell.config["driver"])
import dgm_img_super_resolution_tpu_torch.inference, dgm_img_super_resolution_tpu_torch.models.sd.pipeline
found = core.banned_modules()
assert not found, found
print("ok")
"""
    p = _run(code)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-3000:]


def test_reference_imports_nothing_of_the_port():
    code = r"""
import importlib, pkgutil, sys
import benchmark.reference as ref
for info in pkgutil.iter_modules(ref.__path__):
    importlib.import_module(f"benchmark.reference.{info.name}")
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             {"dgm_img_super_resolution_tpu_torch", "dgm_img_super_resolution_tpu", "jax", "jaxlib", "flax"})
assert not bad, bad
print("ok")
"""
    p = _run(code)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-3000:]


def test_banned_modules_compares_top_level_names_whole():
    from benchmark.harness import core

    sys.modules.setdefault("dgm_img_super_resolution_tpu_torch_fake_probe", sys)
    try:
        assert "dgm_img_super_resolution_tpu_torch_fake_probe" not in core.banned_modules()
    finally:
        del sys.modules["dgm_img_super_resolution_tpu_torch_fake_probe"]
