"""The port's tracer (`utils/metrics.py`: `span`, `count`, `tracing`,
`setup_span`) and the spans and counters of the render path and set-up.

With tracing off a render enters no `record_function` and moves no counter.
Under `torch.profiler` each `render_image` call is one `rtw.render_image`
span, read back as `rtbench` reads a traced window. The plain depth-phased
render (the CPU's `render_fused_deep`, reached through `render_image`) gives
one `rtw.deep.sync` a phase boundary, a `segments` count equal to its
segment bank's sum and a `phase_lane_bounces` count equal to each phase's
lanes times its bounces, and no `refill_lane_bounces` (that counts the
launches on the card's refilling media kernel), so `rtbench`'s
`phase_refill_pct.render` reads nothing there and 100 x refill / phased
lane-bounces where the counter is. The staged path's count is
`trace_rays`'s, and `build_scene` leaves its set-up span.
"""

import time

import pytest
import torch

from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models.scenes import generate_scene
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.scene import builder
from raytracer_weekend_tpu_torch.utils import metrics
from rtbench.trace import WINDOW_SPAN, read_chrome_trace

# Deep enough for the phased render (phases of mk.PHASE_LEN bounces).
DEEP = RenderConfig(width=20, height=12, samples_per_pixel=1, max_depth=30,
                    seed=7)
STAGED = RenderConfig(width=12, height=8, samples_per_pixel=2, max_depth=5,
                      seed=3, ray_batch=64)


@pytest.fixture(scope="module")
def jumpy():
    data, static, cams = generate_scene("jumpy_balls", 16 / 9, device="cpu")
    return data, static, cams[0]


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """`render_image` takes the fused branch on the CPU, where
    `render_fused` is the plain version (the phased one at depth 16+)."""
    monkeypatch.setattr(integrator, "fused_eligible", lambda *a: True)


@pytest.fixture(autouse=True)
def fresh_counters():
    metrics.reset_counters()
    yield
    metrics.reset_counters()


def _profiled(fn, path):
    """Run `fn` under the CPU profiler inside rtbench's window span ->
    the trace as rtbench reads it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            fn()
    prof.export_chrome_trace(str(path))
    return read_chrome_trace(str(path))


def _names(trace, name):
    return [s for s in trace.spans if s.name == name]


@pytest.mark.parametrize("path", ["staged", "phased"])
def test_tracing_off_enters_nothing_and_counts_nothing(jumpy, monkeypatch,
                                                       request, path):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    if path == "phased":
        request.getfixturevalue("fused_on_cpu")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not metrics.on()
    assert metrics.span("rtw.render_image") is metrics.span("x")
    cfg = DEEP if path == "phased" else STAGED
    img = integrator.render_image(*jumpy[:2], cfg, jumpy[2])
    assert img.shape == (cfg.height, cfg.width, 3)
    metrics.count("segments", torch.ones(3))
    assert metrics.counters() == {}


def test_render_image_is_one_span_in_the_window(jumpy, tmp_path):
    trace = _profiled(lambda: integrator.render_image(
        *jumpy[:2], STAGED, jumpy[2]), tmp_path / "trace.json")
    calls = _names(trace, "rtw.render_image")
    assert len(calls) == 1
    lo, hi = trace.window
    assert lo <= calls[0].start and calls[0].start + calls[0].dur <= hi
    # The staged path builds no megakernel tables and renders no phases.
    assert not _names(trace, "rtw.fused.tables")
    assert not _names(trace, "rtw.fused.deep")
    # The counter was on while the profiler recorded.
    assert metrics.counters()["segments"] >= STAGED.n_rays


def test_phased_render_spans_and_counters(jumpy, fused_on_cpu, tmp_path):
    data, static, cam = jumpy
    live = []
    rad, seg = mk.render_fused_deep(data, DEEP, cam, 0, DEEP.n_rays,
                                    DEEP.seed, static=static,
                                    live_counts=live)
    assert metrics.counters() == {}             # tracing was off
    img = []
    trace = _profiled(lambda: img.append(integrator.render_image(
        data, static, DEEP, cam)), tmp_path / "trace.json")
    assert len(live) >= 2                       # two phase boundaries
    assert len(_names(trace, "rtw.deep.sync")) == len(live)
    assert len(_names(trace, "rtw.fused.deep")) == 1
    (call,) = _names(trace, "rtw.render_image")
    for sync in _names(trace, "rtw.deep.sync"):
        assert call.start <= sync.start <= call.start + call.dur
    counts = metrics.counters()
    assert counts["segments"] == int(seg.sum())
    # Phase k runs the lanes alive after phase k - 1 (all of them first)
    # for its bounces, until the depth or the live lanes run out.
    lanes, want, d0 = DEEP.n_rays, 0, 0
    for k in range(len(live) + 1):
        if k:
            lanes = live[k - 1]
        if lanes == 0:
            break
        bounces = min(mk.PHASE_LEN, DEEP.max_depth - d0)
        want += lanes * bounces
        d0 += bounces
    assert counts["phase_lane_bounces"] == want
    assert counts["segments"] <= counts["phase_lane_bounces"]
    assert torch.equal(img[0], rad.reshape(DEEP.height, DEEP.width,
                                           DEEP.samples_per_pixel,
                                           3).sum(dim=2))


def test_refill_share_reads_the_refill_counter():
    from rtbench import common

    reader = common.reader("phase_refill_pct.render")
    data, static, cams = generate_scene("smokey_cornell_box", 16 / 9,
                                        device="cpu")
    assert static.n_volumes
    with metrics.tracing():
        mk.render_fused_deep(data, DEEP, cams[0], 0, DEEP.n_rays, DEEP.seed,
                             static=static)
    counts = metrics.counters()
    # The plain phases launch no kernel, so none refilled.
    assert counts["phase_lane_bounces"] > 0
    assert "refill_lane_bounces" not in counts
    assert reader.read({}) is None
    with metrics.tracing():
        metrics.count("refill_lane_bounces", DEEP.n_rays * mk.PHASE_LEN)
    assert reader.read({}) == pytest.approx(
        100.0 * DEEP.n_rays * mk.PHASE_LEN / counts["phase_lane_bounces"])
    metrics.reset_counters()
    with metrics.tracing():
        metrics.count("refill_lane_bounces", 5)
    assert reader.read({}) is None  # no phased launch at all


def test_tracing_counts_the_staged_segments(jumpy):
    data, static, cam = jumpy
    with metrics.tracing():
        assert metrics.on()
        integrator.render_image(data, static, STAGED, cam)
    assert not metrics.on()
    ids = torch.arange(STAGED.n_rays)
    o, d, t, ray_id = integrator._pixel_rays(cam, STAGED, ids, STAGED.seed)
    _, want = integrator.trace_rays(data, static, STAGED, o, d, t, ray_id,
                                    STAGED.seed, return_stats=True)
    assert metrics.counters() == {"segments": int(want)}
    # A second frame adds its own count.
    with metrics.tracing():
        integrator.render_image(data, static, STAGED, cam)
    assert metrics.counters() == {"segments": 2 * int(want)}


def test_build_scene_leaves_a_setup_span():
    before = metrics.setup_spans()
    t0 = time.perf_counter()
    builder.build_scene([builder.Sphere((0, 0, -1), 0.5,
                                        builder.Lambertian((0.5, 0.5, 0.5)))])
    after = metrics.setup_spans()
    assert len(after) == len(before) + 1
    name, start, end = after[-1]
    assert name == "rtw.setup.scene" and t0 <= start <= end
