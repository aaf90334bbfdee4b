"""Render metrics, tracing and profiling hooks (port of `utils/metrics.py`).

Structured counters: rays/s, ray-segment throughput and wavefront occupancy
per bounce, plus a thin `torch.profiler` wrapper for a device timeline. A
time taken on a card is synchronized before the clock is read; on the CPU
it is the CPU's time and says nothing of a card.

The tracer. `span(name)` marks a stretch of the program: while
`torch.profiler` records it is a `record_function`, which lands in the
Chrome trace as a `user_annotation` on the clock of the device's kernels;
otherwise it costs one check and enters nothing. `count(name, value)` adds
to a counter while tracing is on: while the profiler records, or inside a
`tracing()` block. A tensor's count is its sum, added on the tensor's device
without a host sync; `counters()` reads the totals, `reset_counters()`
clears them. Set-up spans (`setup_span`) are kept whether tracing is on or
not, as (name, start, end) on `time.perf_counter`: `setup_spans()`.

The program's spans and counters, each read by a metric of `rtbench`:
  rtw.render_image      integrator.render_image, the whole call
  rtw.fused.tables      megakernel.build_tables
  rtw.fused.deep        the depth-phased render (megakernel._render_deep)
  rtw.deep.sync         a phase's live count, the host's wait on the card
  segments              render_image: each chunk's per-lane segments
  phase_lane_bounces    each phased launch's lanes x its bounces
  refill_lane_bounces   the same, of the launches on media_kernel (refill)
  rtw.setup.library     _build.load_library's first call
  rtw.setup.scene       scene.builder.build_scene
  rtw.diff.forward      fused_diff._FusedDiff.forward
  rtw.diff.backward     fused_diff._FusedDiff.backward, whole
  rtw.diff.combine      the forward's deferred combine (megakernel._finish)
                        and fused_diff.combine_vjp
  rtw.fit.step          train.FitRun.step: one step, forward through Adam
  rtw.fit.adam          the step's optimizer.step
  diff_lanes            lanes differentiated (each _FusedDiff.forward)
  record_slots          lanes x bounces of each deferring launch's records
  live_records          of those, the records with dcode != 0 (on device)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

_PROFILE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"

_profiling = torch._C._autograd._profiler_enabled


class _NoSpan:
    """The span entered while the profiler is off: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_tracing_blocks = 0
_counts: dict = {}
_setup: list = []


def span(name: str):
    """A `record_function(name)` while the profiler records, else a shared
    object that enters nothing."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def on() -> bool:
    """Counters accumulate: the profiler records, or a `tracing()` block
    is open."""
    return _tracing_blocks > 0 or _profiling()


@contextlib.contextmanager
def tracing():
    """Turn the counters on for the block (blocks nest)."""
    global _tracing_blocks
    _tracing_blocks += 1
    try:
        yield
    finally:
        _tracing_blocks -= 1


def count(name: str, value) -> None:
    """Add `value` (an int, or a tensor: its sum, on its device) to counter
    `name` while tracing is on; otherwise nothing, no device work."""
    if not on():
        return
    if isinstance(value, torch.Tensor):
        value = value.sum()
    prev = _counts.get(name)
    _counts[name] = value if prev is None else prev + value


def counters() -> dict:
    """Every counter's total as an int (a host sync for a device count)."""
    return {name: int(v) for name, v in _counts.items()}


def reset_counters() -> None:
    _counts.clear()


@contextlib.contextmanager
def setup_span(name: str):
    """A set-up span: kept in `setup_spans()` always, and a `span` too."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _setup.append((name, t0, time.perf_counter()))


def setup_spans() -> list:
    """The set-up spans of this process so far, (name, start, end)."""
    return list(_setup)


@dataclasses.dataclass
class RenderStats:
    wall_s: float
    primary_rays: int
    ray_segments: int
    max_depth: int

    @property
    def primary_rays_per_s(self) -> float:
        return self.primary_rays / self.wall_s

    @property
    def segments_per_s(self) -> float:
        return self.ray_segments / self.wall_s

    @property
    def mean_path_length(self) -> float:
        return self.ray_segments / max(self.primary_rays, 1)

    def json_line(self, **extra) -> str:
        d = dict(
            wall_s=round(self.wall_s, 4),
            primary_rays=self.primary_rays,
            ray_segments=self.ray_segments,
            primary_rays_per_s=round(self.primary_rays_per_s, 1),
            segments_per_s=round(self.segments_per_s, 1),
            mean_path_length=round(self.mean_path_length, 3),
            **extra,
        )
        return json.dumps(d)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measured_render(scene, static, cfg, cam, repeats: int = 1) -> RenderStats:
    """Render the frame through `integrator.render_image`, the path users
    take, once under `tracing()` (the warm-up, which also counts its
    segments), then `repeats` times untraced -> throughput stats (host
    clock around synchronized work, the mean over `repeats`)."""
    from raytracer_weekend_tpu_torch import integrator

    device = scene.device
    with torch.no_grad():
        before = counters().get("segments", 0)
        with tracing():
            integrator.render_image(scene, static, cfg, cam)
        segments = counters()["segments"] - before
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            integrator.render_image(scene, static, cfg, cam)
        _sync(device)
        wall = (time.perf_counter() - t0) / repeats
    return RenderStats(wall_s=wall, primary_rays=cfg.n_rays,
                       ray_segments=segments, max_depth=cfg.max_depth)


def wavefront_occupancy(scene, static, cfg, cam, n_lanes: int = 65536):
    """Hit-recording lane fraction per bounce, the compaction-planning
    metric -> (max_depth,) numpy.

    A scene the megakernel renders on this device (`fused_eligible`) reads
    the kernel's per-bounce winner codes over the full frame (code > 0: the
    lane was alive and recorded a hit at that bounce; a miss ending the
    lane there is not counted): a contiguous lane window would be a biased
    sample (the first lanes of a frame are its top rows, often sky). Any
    other scene traces the first `n_lanes` lanes through the staged path at
    increasing depth and differences the segment counts."""
    from raytracer_weekend_tpu_torch import integrator

    whole = dataclasses.replace(cfg, ray_batch=0)
    with torch.no_grad():
        if integrator.fused_eligible(static, whole, scene.device):
            from raytracer_weekend_tpu_torch.ops.cuda.megakernel import (
                render_fused)

            _, _, codes = render_fused(scene, whole, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static,
                                       emit_paths=True)
            return (codes > 0).float().mean(dim=0).cpu().numpy()

        n = min(n_lanes, cfg.n_rays)
        ids = torch.arange(n, dtype=torch.int64, device=scene.device)
        o, d, t, ray_id = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
        counts = []
        for depth in range(1, cfg.max_depth + 1):
            sub = dataclasses.replace(cfg, max_depth=depth)
            _, segs = integrator.trace_rays(scene, static, sub, o, d, t,
                                            ray_id, cfg.seed,
                                            return_stats=True)
            counts.append(int(segs))
    return np.diff([0] + counts) / n


@contextlib.contextmanager
def profiler_trace(log_dir: str | os.PathLike = _PROFILE_DIR):
    """A `torch.profiler` trace (CPU, and CUDA where there is a card) around
    the block, written as a Chrome trace to `log_dir`/trace.json; yields
    the profiler, whose `key_averages()` give time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
