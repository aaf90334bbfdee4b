"""The check that decides `correct`, at a size a CPU test holds: a whole run
(the look for a card skipped, the program's plain path on the CPU) passes,
the same run with its timed path broken underneath fails, and the control
(the reference in bfloat16 in the program's place) reads above each cell's
limit."""

from __future__ import annotations

import time

import pytest

from rtbench import common, control, run

SEED = 2 ** 40 + 4242
SMALL = {"config": {"width": 24, "height": 14}}
# Book 2 at depth 50 takes seconds a pass on the CPU: a smaller frame and
# fewer samples, so that the window holds several passes.
FRAME = {"rtw1_final.pass16": {"width": 24, "height": 14},
         "rtw2_final.pass10": {"width": 12, "height": 7}}
TRAFFIC = {"check_pixels": 128, "check_within": 3, "warmup_passes": 1}
SPP = {"rtw2_final.pass10": {"spp_per_pass": 2}}
SECONDS = {"rtw2_final.pass10": 8.0}


def _run(cell, faults=None):
    overrides = {"config": FRAME[cell],
                 "traffic": {**TRAFFIC, **SPP.get(cell, {})}}
    return run.run_cell(cell, SEED, SECONDS.get(cell, 2.0), False,
                        device="cpu",
                        t_start=time.perf_counter(), faults=faults,
                        overrides=overrides)


CELLS = [w["name"] for w in common.manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_render_run_is_correct(name):
    line = _run(name)
    assert line["attempted"] >= 2
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = common.find_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
@pytest.mark.parametrize("name", CELLS)
def test_render_fault_is_caught(name, fault):
    """A pass that returns the last pass's frame; half the samples, the
    mean over the rest; every answer altered where it is produced (its
    rows in the wrong order)."""
    line = _run(name, {fault: True})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_render_control_fails(name):
    cell = common.find_cell(name)
    cell.config.update(SMALL["config"])
    cell.traffic.update(check_pixels=48)
    got = control.render_readings(cell, SEED, "cpu", passes=1)
    assert got["control"]["pass_rel_l1"] > cell.limits["pass_rel_l1"]
