"""The comparison that decides ``correct`` fails what it has to fail, at
tiny widths on the CPU, through the whole of a run but the look for a
card: the control (the plain reference computed in float8 e4m3, put in the
program's place), and each fault a serving cell can have, planted in the
port underneath the timed path: a sampler step that returns its state
unchanged, half of the batch left out (its images the other half's), and
an answer altered where it is produced (``harness/faults.py``). A sound run of the same tiny cell
passes the same limits.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import core, faults, spec
from benchmark.reference import precision as P
from benchmark.tests.tiny import tiny_cell

SEED = 2**34 + 101
SRDIFF_CELLS = ["srdiff_b8_lr128", "srdiff_b1_lr128"]
SD_CELLS = ["sd_b1_lr256", "sd_b1_lr128"]


def _run(name: str, driver_cls=None) -> dict:
    cell = tiny_cell(name)
    return core.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter(), driver_cls=driver_cls)


@pytest.mark.parametrize("name", SRDIFF_CELLS + SD_CELLS)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["_check"]


def _control(name: str):
    base = spec.driver_module(spec.resolve(name).config["driver"]).Driver

    class Control(base):
        """The reference in float8 in the program's place: same inputs,
        same weights (drawn again from the seed), the program's output type."""

        def build(self, seed):
            self.seed = seed
            self.model = self.reference_model("meta")
            self.model.load_state_dict({k: v.float() for k, v in core._flat(self.weights(seed)).items()},
                                       assign=True)

        def call(self, req):
            with P.computed_in("float8"):
                out = self.reference(self.model, req)
            return out if self.expected()[1] == torch.float32 else torch.round(out * 255.0).to(torch.uint8)

        def capture_s(self):
            return None

    return Control


@pytest.mark.parametrize("name", SRDIFF_CELLS + SD_CELLS)
def test_the_control_is_not_correct(name):
    r = _run(name, driver_cls=_control(name))
    assert r["failed"] == 0
    assert not r["correct"], r["_check"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in SRDIFF_CELLS + SD_CELLS for f in
                                        faults.names(spec.resolve(n).config["driver"],
                                                     int(spec.resolve(n).traffic["batch"]))])
def test_each_fault_is_not_correct(name, fault):
    with faults.planted(spec.resolve(name).config["driver"], fault):
        r = _run(name)
    assert not r["correct"], r["_check"]
