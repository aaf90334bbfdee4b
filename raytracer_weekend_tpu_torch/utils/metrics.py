"""Render metrics and profiling hooks (port of `utils/metrics.py`).

Structured counters: rays/s, ray-segment throughput and wavefront occupancy
per bounce, plus a thin `torch.profiler` wrapper for a device timeline. A
time taken on a card is synchronized before the clock is read; on the CPU
it is the CPU's time and says nothing of a card.
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
    """Render through the staged path with the segment counter on, after
    one warm-up pass -> throughput stats (host clock around synchronized
    work, the mean over `repeats`)."""
    from raytracer_weekend_tpu_torch import integrator

    device = scene.device
    n = cfg.n_rays
    batch = cfg.ray_batch or n
    id_chunks = [torch.arange(s, min(s + batch, n), dtype=torch.int64,
                              device=device) for s in range(0, n, batch)]

    def chunk(ids):
        o, d, t, ray_id = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
        return integrator.trace_rays(scene, static, cfg, o, d, t, ray_id,
                                     cfg.seed, return_stats=True)

    with torch.no_grad():
        for ids in id_chunks:                 # warm-up: builds, caches
            chunk(ids)
        _sync(device)
        t0 = time.perf_counter()
        total_segments = 0
        for _ in range(repeats):
            segs = [chunk(ids)[1] for ids in id_chunks]
            total_segments = int(sum(int(s) for s in segs))
        _sync(device)
        wall = (time.perf_counter() - t0) / repeats
    return RenderStats(wall_s=wall, primary_rays=n,
                       ray_segments=total_segments, max_depth=cfg.max_depth)


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
