"""The readers of the program's own spans and counters, on a hand-made
traced window: the host spans per pass, the device's idle counted by its
overlap with the phased render's spans, the counters' ratios, the set-up
spans, and None wherever there is nothing to read (no trace, no span, no
counter, or a program without the tracer)."""

from __future__ import annotations

import pytest

from raytracer_weekend_tpu_torch.utils import metrics
from rtbench import common
from rtbench.trace import WINDOW_SPAN, DeviceOp, Span, TraceData

NEW = ("wrapper_ms.render", "tables_ms.render", "phase_wait_ms.render",
       "phase_idle_ms.render", "phase_lane_use_pct.render",
       "segments_per_sample.render", "library_s.setup", "scene_s.setup")


def _read(name, out):
    return common.reader(name).read(out)


def _op(start, end):
    return DeviceOp("rtw::kernel", "kernel", start, end - start, None, 0)


def _span(name, start, end):
    return Span(name, 1, start, end - start)


def _out(spans=(), ops=(), units=2):
    """A traced window (0, 10) s of `units` passes at 3 samples/s."""
    trace = TraceData(list(ops), {}, [_span(WINDOW_SPAN, 0.0, 10.0),
                                      *spans], (0.0, 10.0))
    return {"trace": trace, "units": units, "samples_per_s": 3.0,
            "window_s": 10.0}


@pytest.fixture(autouse=True)
def no_counts(monkeypatch):
    metrics.reset_counters()
    monkeypatch.setattr(metrics, "_setup", [])
    yield
    metrics.reset_counters()


def test_phase_idle_counts_the_overlap_of_each_idle_interval():
    """Ops [1, 3] and [2, 4] (one busy stretch) and [6, 7] leave the
    window idle on [0, 1], [4, 6] and [7, 10]; the phased renders [0.5, 5]
    and [6.5, 8] hold 0.5 + 1 + 1 s of it (the gap [4, 6] counts by its
    overlap, not by its midpoint), over 2 passes."""
    out = _out([_span("rtw.fused.deep", 0.5, 5.0),
                _span("rtw.fused.deep", 6.5, 8.0)],
               [_op(1.0, 3.0), _op(2.0, 4.0), _op(6.0, 7.0)])
    assert _read("phase_idle_ms.render", out) == pytest.approx(1250.0)
    # No device op at all: the spans' whole length is idle.
    out = _out([_span("rtw.fused.deep", 0.5, 5.0)])
    assert _read("phase_idle_ms.render", out) == pytest.approx(2250.0)


def test_host_spans_a_pass():
    """Two render_image calls of 4 s hold 1.5 s of syncs; the tables take
    0.3 s, one span of them clipped at the window's end."""
    out = _out([_span("rtw.render_image", 0.0, 4.0),
                _span("rtw.deep.sync", 1.0, 2.0),
                _span("rtw.fused.tables", 0.1, 0.3),
                _span("rtw.render_image", 5.0, 9.0),
                _span("rtw.deep.sync", 6.0, 6.5),
                _span("rtw.fused.tables", 9.9, 10.5),
                _span("aten::copy_", 1.0, 3.0)])
    assert _read("wrapper_ms.render", out) == pytest.approx(3250.0)
    assert _read("phase_wait_ms.render", out) == pytest.approx(750.0)
    assert _read("tables_ms.render", out) == pytest.approx(150.0)


def test_counter_ratios():
    with metrics.tracing():
        metrics.count("segments", 20)
        metrics.count("segments", 10)
        metrics.count("phase_lane_bounces", 40)
    out = _out()
    assert _read("phase_lane_use_pct.render", out) == pytest.approx(75.0)
    assert _read("segments_per_sample.render", out) == pytest.approx(1.0)


def test_setup_spans(monkeypatch):
    monkeypatch.setattr(metrics, "_setup", [
        ("rtw.setup.library", 1.0, 3.5), ("rtw.setup.scene", 4.0, 4.25)])
    assert _read("library_s.setup", _out()) == pytest.approx(2.5)
    assert _read("scene_s.setup", _out()) == pytest.approx(0.25)


@pytest.mark.parametrize("without", ["spans", "trace", "tracer"])
@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name, without, monkeypatch):
    """A window without the program's spans and counters (the parent's
    program), no trace at all, or a program whose metrics module has no
    tracer: None, never 0."""
    out = _out([_span("aten::mul", 1.0, 2.0)], [_op(1.0, 2.0)])
    if without == "trace":
        out["trace"] = None
    elif without == "tracer":
        with metrics.tracing():
            metrics.count("segments", 5)
            metrics.count("phase_lane_bounces", 9)
        monkeypatch.setattr(metrics, "_setup", [("rtw.setup.scene", 0, 1),
                                                ("rtw.setup.library", 0, 1)])
        monkeypatch.delattr(metrics, "counters")
        monkeypatch.delattr(metrics, "setup_spans")
    assert _read(name, out) is None


def test_every_new_metric_is_in_the_manifest():
    per_layer = {m["name"]: m for m in common.manifest()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"]
