"""The fit cells' check at a size a CPU test holds: a whole run (the look for
a card skipped, the program's plain path on the CPU) passes; the same run
with a fault planted under its timed path fails (a frozen step, half the
samples, a gradient with its rows flipped); the control (the reference in
bfloat16 in the program's place) reads above each limit. Then the fit
cells' readers on a hand-made traced window."""

from __future__ import annotations

import time

import pytest

from raytracer_weekend_tpu_torch.utils import metrics
from rtbench import common, control_fit, run
from rtbench.trace import WINDOW_SPAN, DeviceOp, Span, TraceData

SEED = 2 ** 40 + 4242
FIT = [w["name"] for w in common.manifest()["workloads"]
       if common.find_cell(w["name"]).kind == "fit_steps"]
FRAME = {"width": 32, "height": 18, "max_depth": 6}
TRAFFIC = {"spp_per_pass": 2, "target_spp": 8, "warmup_steps": 1,
           "check_within": 3}


def _run(cell, faults=None):
    return run.run_cell(cell, SEED, 1.0, False, device="cpu",
                        t_start=time.perf_counter(), faults=faults,
                        overrides={"config": FRAME, "traffic": TRAFFIC})


def test_the_fit_cell_is_in_the_manifest():
    assert FIT == ["earth.fit16"]


@pytest.mark.parametrize("name", FIT)
def test_fit_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = common.find_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(line["checks"]) == {"loss_rel", "grad_rel_l1",
                                   "step_rel_l1", "nonfinite"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["frozen", "half", "grad"])
@pytest.mark.parametrize("name", FIT)
def test_fit_fault_is_caught(name, fault):
    """Adam's step leaves the parameters; half the samples a step; each
    gradient's rows in the wrong order (the texels' rows, the textures'
    rows) before Adam's step."""
    line = _run(name, {fault: True})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", FIT)
def test_fit_control_fails_each_limit(name):
    cell = common.find_cell(name)
    cell.config.update(FRAME)
    cell.traffic.update(TRAFFIC)
    got = control_fit.fit_readings(cell, SEED, "cpu")["control"]
    for key in ("loss_rel", "grad_rel_l1", "step_rel_l1"):
        assert got[key] > cell.limits[key], (key, got[key])


# -- the readers ------------------------------------------------------------

FIT_METRICS = ("bwd_ms.fit", "glue_ms.fit", "device_idle_pct.fit",
               "record_use_pct.fit", "fwd_roofline.fit", "bwd_roofline.fit")


def _window(spans=(), ops=(), launches=None, units=2):
    """A traced window (0, 10) s of `units` steps."""
    trace = TraceData(list(ops), launches or {},
                      [Span(WINDOW_SPAN, 1, 0.0, 10.0), *spans], (0.0, 10.0))
    return {"trace": trace, "units": units, "work": {
        "forward": (6.7e12, 1.0), "backward": (1.0, 3.35e11)}}


@pytest.fixture(autouse=True)
def no_counts():
    metrics.reset_counters()
    yield
    metrics.reset_counters()


def test_fit_readers_on_a_window():
    """The forward span [1, 3] launches a port kernel of 0.5 s, the backward
    span [4, 8] one of 2 s and a library kernel of 1 s; a 0.25 s port
    kernel launched outside both belongs to neither."""
    ops = [DeviceOp("sphere_kernel", "kernel", 1.5, 0.5, 1, 0),
           DeviceOp("replay_bwd_kernel", "kernel", 4.5, 2.0, 2, 0),
           DeviceOp("at::native::add_kernel", "kernel", 7.0, 1.0, 3, 0),
           DeviceOp("sphere_kernel", "kernel", 9.0, 0.25, 4, 0)]
    launches = {1: Span("cudaLaunchKernel", 1, 1.1, 0.01),
                2: Span("cudaLaunchKernel", 2, 4.2, 0.01),
                3: Span("cudaLaunchKernel", 2, 6.9, 0.01),
                4: Span("cudaLaunchKernel", 1, 8.9, 0.01)}
    out = _window([Span("rtw.diff.forward", 1, 1.0, 2.0),
                   Span("rtw.diff.backward", 2, 4.0, 4.0)], ops, launches)
    read = {m: common.reader(m).read(out) for m in FIT_METRICS}
    assert read["bwd_ms.fit"] == pytest.approx(2000.0)
    assert read["glue_ms.fit"] == pytest.approx(500.0)
    assert read["device_idle_pct.fit"] == pytest.approx(62.5)
    # Forward: 0.1 s of least time over 0.25 s a step; backward 0.1 s over
    # 1 s a step.
    assert read["fwd_roofline.fit"] == pytest.approx(40.0)
    assert read["bwd_roofline.fit"] == pytest.approx(10.0)
    assert read["record_use_pct.fit"] is None
    with metrics.tracing():
        metrics.count("record_slots", 200)
        metrics.count("live_records", 9)
    assert common.reader("record_use_pct.fit").read(out) == \
        pytest.approx(4.5)


@pytest.mark.parametrize("name", FIT_METRICS)
def test_fit_readers_without_the_tracer_read_none(name):
    """A window without the program's spans, counters or kernels (the
    parent's program, whose fit carries none): None, never 0."""
    out = _window([Span("aten::mul", 1, 1.0, 1.0)])
    if name in ("glue_ms.fit", "device_idle_pct.fit"):
        out["trace"] = None
    assert common.reader(name).read(out) is None
