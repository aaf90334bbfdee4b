"""Traffic `render_passes`: a progressive viewer's closed loop of render
passes through the program's `integrator.render_image`.

Parameters (the traffic file): `spp_per_pass` samples a pixel in each pass,
`in_flight` passes submitted before the viewer waits for the oldest,
`warmup_passes` passes in the set-up, and the check's `check_passes` passes
drawn from the first `check_within` (and the window's last one), each
compared on `check_pixels` pixels drawn from the seed.

Every pass has a seed of its own (from the run's seed and the pass's
index), so each renders other samples of the same frame; the passes are
summed on the device, as the viewer's running image. The scene is the
configuration's, the same in every run: the seed changes which samples are
traced, not how much work they are.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from rtbench import common, port
from rtbench.reference import compare, rates, roofline
from rtbench.reference import render as R
from rtbench.reference import scenes


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", faults: dict | None = None):
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.config import RenderConfig

    faults = faults or {}
    conf, traf = cell.config, cell.traffic
    W, H, D = conf["width"], conf["height"], conf["max_depth"]
    spp = int(traf["spp_per_pass"])
    in_flight = int(traf["in_flight"])
    desc = scenes.make_scene(conf)
    scene, static, cam = port.build(desc, device)
    base = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                        max_depth=D, seed=0,
                        use_log10_volume_sampling=conf["log10_volume"])

    def render(key, i):
        cfg = dataclasses.replace(base, seed=common.derive(seed, key, i))
        if "half" in faults:                    # half the samples, mean x 2
            cfg = dataclasses.replace(cfg, samples_per_pixel=max(spp // 2, 1))
            img = integrator.render_image(scene, static, cfg, cam) * 2.0
        else:
            img = integrator.render_image(scene, static, cfg, cam)
        if "alter" in faults:                   # rows in the wrong order
            img = img.flip(0)
        return img

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    acc = torch.zeros((H, W, 3), device=device)
    for k in range(int(traf["warmup_passes"])):
        acc += render(common.WARM, k)
    acc.zero_()
    sync()
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(common.derive(seed, common.CHECK))
    check = set(int(i) for i in rng.choice(int(traf["check_within"]),
                                           int(traf["check_passes"]),
                                           replace=False))
    kept, last, stale = {}, None, None
    lat, pending = [], collections.deque()
    window = min(seconds, float(traf.get("trace_seconds", seconds))) \
        if trace else seconds
    prof = None
    if trace:
        from rtbench.trace import WINDOW_SPAN, Profiler

        prof = Profiler().__enter__()
        span = torch.profiler.record_function(WINDOW_SPAN).__enter__()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < window:
        t_sub = time.perf_counter()
        img = render(common.PASS, i)
        if "stale" in faults and stale is not None:
            img = stale                         # the pass returns the last
        stale = img
        acc += img
        ev = torch.cuda.Event() if device != "cpu" else None
        if ev is not None:
            ev.record()
        pending.append((t_sub, ev))
        if i in check:
            kept[i] = img
        last = (i, img)
        i += 1
        while len(pending) >= in_flight:
            t_s, e = pending.popleft()
            if e is not None:
                e.synchronize()
            lat.append(time.perf_counter() - t_s)
    while pending:
        t_s, e = pending.popleft()
        if e is not None:
            e.synchronize()
        lat.append(time.perf_counter() - t_s)
    sync()
    t1 = time.perf_counter()
    if trace:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    passes, window_s = i, t1 - t0
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    acc_finite = bool(torch.isfinite(acc).all())
    kept[last[0]] = last[1]
    kept = {k: v.detach().reshape(-1, 3).cpu() for k, v in kept.items()
            if k < passes}
    del scene, acc, img, last, stale
    if device != "cpu":
        torch.cuda.empty_cache()

    # The check: the plain reference on the sampled pixels of kept passes.
    t_ref = time.perf_counter()
    R.tf32_off()
    T = R.Tables.build(desc, device)
    cam_r = R.camera_frame(desc.camera, device, torch.float32)
    n_pix = min(int(traf["check_pixels"]), W * H)
    worst, nonfinite = 0.0, 0
    for k in sorted(kept):
        pix = torch.from_numpy(np.sort(rng.choice(W * H, n_pix,
                                                  replace=False)))
        ref = R.render_pixels(T, cam_r, W, H, spp, D, pix.to(device),
                              common.derive(seed, common.PASS, k),
                              log10=conf["log10_volume"]).cpu()
        prog = kept[k][pix]
        nonfinite += int((~torch.isfinite(prog)).sum())
        worst = max(worst, compare.rel_l1(prog, ref))
    common.note(f"setup_s {setup_s:.3f}, window {window_s:.3f} s, "
                f"{passes} passes, reference "
                f"{time.perf_counter() - t_ref:.3f} s")
    limits = cell.limits
    checks = [("pass_rel_l1", worst, limits["pass_rel_l1"]),
              ("nonfinite_px", nonfinite, 0)]

    out = dict(setup_s=setup_s, window_s=window_s, units=passes,
               samples_per_s=rates.samples_per_s(W, H, spp, passes,
                                                 window_s),
               frame_ms_p95=common.quantile95(lat) * 1e3 if lat else None,
               latencies_ms=[x * 1e3 for x in lat],
               attempted=passes, failed=0 if acc_finite else passes,
               peak=peak, checks=checks, count=1,
               trace=prof.data if prof else None,
               work=roofline.render_pass(conf, spp))
    return out
