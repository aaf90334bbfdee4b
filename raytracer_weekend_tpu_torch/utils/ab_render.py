"""Two checkouts of the port on one card: the kernels' outputs compared
(bit for bit, or within budgets where float atomics sum them), and their
times in turns.

    python raytracer_weekend_tpu_torch/utils/ab_render.py --other DIR \
        [--only forward|backward|hits|k6a] [--out build/ab_render.json]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive` into a git-ignored directory).
Each checkout runs in its own process, with its own package on
PYTHONPATH and its own kernel build, in the order other, this, this,
other; each builds and saves into the git-ignored build/ of its
checkout and of this one. Each process renders, at 400x225, 16 spp, depth 8, render seed 0,
cornell_box, wavefront_cow_obj, textured_monument and book2_final_scene
(the planar loop, K3), jumpy_balls (spheres only, K1) and
smokey_cornell_box and sphere_medium (media, K5) through `render_fused`
(radiance and segments; the winner codes of `emit_paths=True` too, K1-emit
on jumpy_balls, K5-emit on the media scenes), two_perlin_spheres and earth
through `render_fused_records`
(K6a: radiance, segments and the records ctb, abc, dcode), and
many_spheres at 400x225, 4 spp, depth 8 (3,970 spheres: the sphere-only
kernel's table read from global memory); each is timed (CUDA events,
median of 5) as the call and as the launch alone (`_launch` on the tables
built beforehand). Then K8 on two_perlin_spheres' records (the
combine's points and live mask at that size): `turbulence`'s output, and
its launch alone on operands built beforehand and its call timed. Then
bench.py's
book2_criterion (40x22, 100 spp, depth 50, seeds 1337) and jumpy_balls at
400x225, 4 spp, depth 20 through the single pass and the depth-phased
render, each timed. Then the staged
path's closest-hit kernels: K10 on jumpy_balls, K11 and K12 on
cornell_box and the cow, on the frame's primary rays and its first-bounce
rays (one bounce of the checkout's staged path, so equal in the two
checkouts where their primary hits are), and each on phase 14's random
table (`checks.random_hit_case`, 100,000 rays): (t, idx) through the
autograd.Function; timed (CUDA events, median of 5) at the sizes of
PERF.md's kernel table (the first 2^18 primary rays, and all 1.44M for
K10 on jumpy and K11 on cornell): the launch alone, on its table and ray
operands built beforehand, by CUDA events ("launch") and with the card
kept busy while the host enqueues it ("device launch", median of 21; see
`--only k6a` below), and the Function's call as the checkout's staged
path makes it, for the wrapper's time; the launch alone also by device
time on each scene's first-bounce rays and on the random tables. Last,
the staged path end to end: `render_image` of jumpy_balls with a uv-debug
ground (K10, one chunk) and the cow's staged frame in 2^18-lane chunks
(`render_chunk`, K10-K12), their images and timings.

The backward kernels (all of the above is the forward part; `--only`
runs one part): K9 on two_perlin_spheres' records at 400x225x16 d8 (the
combine's points and live mask, a random cotangent), K7 on
two_perlin_spheres, earth and simple_light with the combine's real
cotangents of g = 2 rad, K2 on jumpy_balls and K4 on cornell_box with g =
2 rad, each on the checkout's own forward codes (the forward kernels are
bitwise alike across the checkouts this compares): d_p and d_o, d_d,
d_time compared bit for bit, d_grad within TURB_NORM_REL and the table
and background cotangents within TAB_NORM_REL of the other checkout's;
each timed as the launch alone on operands built beforehand and as the
call (`turbulence_vjp`, `replay_bwd_fused`); a checkout without launch-
alone entry points is driven through its own library on the operands its
call builds. Then the forward+backward frames of two_perlin_spheres, earth
and simple_light (`render_fused_diff` and the gradient of the radiance sum
w.r.t. every float leaf) and 3 Adam steps of `InverseRenderer.fit` on
earth's image atlas (step ms by the host clock).

`--only hits` runs the closest-hit kernels K10-K12 of the forward part
alone (their outputs and times, not the staged frames).

`--only k6a` times K6a alone (two_perlin_spheres' records at 400x225x16
d8, the launch alone on tables built beforehand, median of 21) at three
points of one process: first, after the media scenes' launches
(smokey_cornell_box and sphere_medium, K5) and after K8 on the same
records; each by CUDA events around the launch as above ("events") and
with the card kept busy while the host enqueues it (`torch.cuda._sleep`
ahead of the start event: "device", the host's time left out). Its runs
are other, this, this with the other checkout's kernel library, then the
three again in reverse (the library run skips K8, whose C signature the
two checkouts may not share).

The first process of each checkout saves its outputs, and the script
reports for each output whether the two checkouts agree, and each time by
checkout. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

# This checkout's timers, imported as a sibling of this script: each child
# process runs this file on its checkout's package, which may predate them.
from timing import cuda_ms, device_ms

FULL = dict(width=400, height=225, samples_per_pixel=16, max_depth=8)
SCENES = ("cornell_box", "wavefront_cow_obj", "textured_monument",
          "book2_final_scene", "jumpy_balls", "smokey_cornell_box",
          "sphere_medium", "two_perlin_spheres", "earth", "many_spheres")
EMIT = ("cornell_box", "wavefront_cow_obj", "textured_monument",
        "book2_final_scene", "jumpy_balls", "smokey_cornell_box",
        "sphere_medium")
# Through render_fused_records (K6a's own outputs); many_spheres at 4 spp.
RECORDS = ("two_perlin_spheres", "earth")
SIZE = {"many_spheres": dict(FULL, samples_per_pixel=4)}
CRITERION = dict(width=40, height=22, samples_per_pixel=100, max_depth=50,
                 seed=1337)
JUMPY_DEEP = dict(width=400, height=225, samples_per_pixel=4, max_depth=20)
# The staged closest-hit kernels: (family, scene) compared; the sizes each
# is timed at.
HITS = (("spheres", "jumpy_balls"), ("rects", "cornell_box"),
        ("triangles", "cornell_box"), ("rects", "wavefront_cow_obj"),
        ("triangles", "wavefront_cow_obj"), ("spheres", "wavefront_cow_obj"))
HIT_SIZES = {("spheres", "jumpy_balls"): (1 << 18, 1_440_000),
             ("rects", "cornell_box"): (1 << 18, 1_440_000)}
# The backward kernels: (kernel, scene) on full frames. Outputs whose key
# ends in " summed" are float-atomic sums, compared within a budget: K9's
# d_grad (chip_smoke.py's TURB_NORM_REL), the replay backward's table and
# background cotangents (its K2 budget).
BACKWARD = (("K7", "two_perlin_spheres"), ("K7", "earth"),
            ("K7", "simple_light"), ("K2", "jumpy_balls"),
            ("K4", "cornell_box"))
FWD_BWD = ("two_perlin_spheres", "earth", "simple_light")
TURB_NORM_REL, TAB_NORM_REL = 1e-4, 1e-3


def run_one(out_dir: pathlib.Path, save: bool, only: str | None,
            lib: str | None = None) -> dict:
    """Render and time everything (or `only` the forward, the backward,
    the k6a or the hits part) with the package on sys.path, its kernels
    from `lib` when given (the k6a part only); save the outputs under
    out_dir when `save`. -> {render: ms}."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ab_render needs a CUDA device")
    dev = torch.device("cuda", 0)
    times, outs = {}, {}
    if lib:
        from raytracer_weekend_tpu_torch.ops.cuda import _build

        _build.build = lambda: pathlib.Path(lib)
    if only == "k6a":
        k6a_order(dev, outs, times, k8=lib is None)
    if only in (None, "forward"):
        forward_kernels(dev, outs, times)
    if only == "hits":
        staged_hits(dev, outs, times)
    if only in (None, "backward"):
        backward_kernels(dev, outs, times)
    torch.cuda.synchronize()
    if save:
        torch.save({k: [t.cpu() for t in v] for k, v in outs.items()},
                   out_dir / "outputs.pt")
    return times


def _scene(name, cfg, dev):
    """(scene, static, camera) of a catalog scene or of another scene
    function of `models.scenes` (sphere_medium), on `dev`."""
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    if name in scenes.SCENES:
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device=dev)
    else:
        objs, cams, bg = getattr(scenes, name)(cfg.aspect_ratio)
        scene, static = build_scene(objs, background=bg)
        scene = scene.to(dev)
    return scene, static, cams[0].to(dev)


def forward_kernels(dev, outs, times):
    """The forward kernels and the staged path (see the module's
    docstring) into `outs` and `times`."""
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    for name in SCENES:
        cfg = RenderConfig(**SIZE.get(name, FULL))
        scene, static, cam = _scene(name, cfg, dev)
        tables = mk.build_tables(scene, static, cam)

        def fwd(emit=False):
            if name in RECORDS:
                return mk.render_fused_records(scene, cfg, cam, 0, cfg.n_rays,
                                               cfg.seed, static=static,
                                               emit_paths=emit)
            return mk.render_fused(scene, cfg, cam, 0, cfg.n_rays, cfg.seed,
                                   static=static, emit_paths=emit,
                                   deep=False)

        def launch(emit=False):
            return mk._launch(scene, cfg, cam, 0, cfg.n_rays, cfg.seed,
                              static, emit_paths=emit, tables=tables)

        outs[name] = fwd()
        times[name] = cuda_ms(fwd)
        times[f"launch {name}"] = cuda_ms(launch)
        if name in EMIT:
            outs[f"{name} codes"] = fwd(True)
            times[f"{name} codes"] = cuda_ms(lambda: fwd(True))
            times[f"launch {name} codes"] = cuda_ms(lambda: launch(True))
    turbulence_records(dev, outs, times)
    for name, size in (("book2_criterion", CRITERION),
                       ("jumpy_balls_d20", JUMPY_DEEP)):
        cfg = RenderConfig(**size)
        if name == "book2_criterion":
            objs, cams, bg = scenes.book2_final_scene(cfg.aspect_ratio,
                                                      seed=cfg.seed)
            scene, static = build_scene(objs, background=bg, seed=cfg.seed)
            scene = scene.to(dev)
        else:
            scene, static, cams = scenes.generate_scene(
                "jumpy_balls", cfg.aspect_ratio, device=dev)
        cam = cams[0].to(dev)
        for route, deep in (("single", False), ("deep", True)):
            def fwd():
                return mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static, deep=deep)

            outs[f"{name} {route}"] = fwd()
            times[f"{name} {route}"] = cuda_ms(fwd)
    staged_hits(dev, outs, times)
    staged_frames(dev, outs, times)


def k6a_order(dev, outs, times, k8=True):
    """K6a on two_perlin_spheres first, after the media scenes' launches
    and (with `k8`) after K8 (see the module's docstring)."""
    import torch

    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    def frame(name):
        cfg = RenderConfig(**FULL)
        scene, static, cam = _scene(name, cfg, dev)
        tables = mk.build_tables(scene, static, cam)
        return lambda: mk._launch(scene, cfg, cam, 0, cfg.n_rays, cfg.seed,
                                  static, tables=tables)

    k6a = frame("two_perlin_spheres")
    outs["two_perlin_spheres k6a"] = k6a()

    def timed(when):
        times[f"events K6a {when}"] = cuda_ms(k6a, 21)
        times[f"device K6a {when}"] = device_ms(k6a)

    timed("first")
    for name in ("smokey_cornell_box", "sphere_medium"):
        media = frame(name)
        for _ in range(10):
            media()
    torch.cuda.synchronize()
    timed("after media")
    if k8:
        turbulence_records(dev, outs, times)
        timed("after K8")


def noise_records(dev):
    """two_perlin_spheres' records at FULL: (grad, perm, points (B*D, 3),
    live (B*D,)), the combine's turbulence operands."""
    from raytracer_weekend_tpu_torch import textures
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    cfg = RenderConfig(**FULL)
    scene, static, cams = scenes.generate_scene(
        "two_perlin_spheres", cfg.aspect_ratio, device=dev)
    _, _, _, abc, dcode = mk.render_fused_records(
        scene, cfg, cams[0].to(dev), 0, cfg.n_rays, cfg.seed, static=static)
    tid = (dcode.abs() - 1).clamp_min(0).long()
    live = (dcode != 0) & (scene.textures.ttype[tid] == textures.NOISE)
    return (scene.textures.perlin_grad, scene.textures.perlin_perm,
            abc.reshape(-1, 3), live.reshape(-1))


def turbulence_records(dev, outs, times):
    """K8 on two_perlin_spheres' records: its output, the launch alone and
    the call."""
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    grad, perm, pts, live = noise_records(dev)

    def call():
        return pt.turbulence(grad, perm, pts, 7, live)

    ops = pt.turbulence_operands(grad, perm, pts, live)
    outs["K8 two_perlin_spheres"] = (call(),)
    times["launch K8 two_perlin_spheres"] = cuda_ms(
        lambda: pt._launch_turbulence(ops))
    times["call K8 two_perlin_spheres"] = cuda_ms(call)


def _hit_calls(kind, tab, rays, t_min):
    """(the launch alone, the Function's call) of the checkout's kernel for
    `kind`, as zero-argument callables, on operands built beforehand. A
    checkout whose wrappers build the table and the per-ray operands on
    every launch (the first design: no `ray_operands`) is driven through
    its own `_build.launch_closest_hit` on the operands it would build."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import (
        _build, rect_intersect, sphere_intersect, triangle_intersect)

    mod, kern, build = {
        "spheres": (sphere_intersect, sphere_intersect.hit_spheres_kernel,
                    sphere_intersect.sphere_table),
        "rects": (rect_intersect, rect_intersect.hit_rects_kernel,
                  rect_intersect.rect_table),
        "triangles": (triangle_intersect,
                      triangle_intersect.hit_triangles_kernel,
                      triangle_intersect.triangle_table)}[kind]
    table = build(tab)
    if hasattr(mod, "ray_operands"):
        ops = mod.ray_operands(*rays)
        return (lambda: mod._launch(table, ops, t_min),
                lambda: kern(tab, *rays, t_min, table=table))
    from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops
    from raytracer_weekend_tpu_torch.vecmath import cross

    o, d = rays[0].contiguous(), rays[1].contiguous()
    ops = {"spheres": lambda: (o, d, rays[2].contiguous(), torch.stack(
               sphere_ops.ray_terms(o, d), dim=1)),
           "rects": lambda: (o, d),
           "triangles": lambda: (o, d, cross(o, d))}[kind]()
    entry = {"spheres": "rtw_hit_spheres", "rects": "rtw_hit_rects",
             "triangles": "rtw_hit_triangles"}[kind]
    return (lambda: _build.launch_closest_hit(entry, ops, table, t_min),
            lambda: kern(tab, *rays, t_min))


def staged_hits(dev, outs, times):
    """The staged path's closest-hit kernels (see the module's docstring)
    into `outs` and `times`."""
    import dataclasses

    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import checks

    for name in dict.fromkeys(n for _, n in HITS):
        cfg = RenderConfig(**FULL)
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device=dev)
        cam = cams[0].to(dev)
        ids = torch.arange(cfg.n_rays, device=dev)
        o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
        *_, (o1, d1, _, _, alive, _) = integrator.trace_lanes(
            scene, static, dataclasses.replace(cfg, max_depth=1), o, d, t,
            rid, cfg.seed, return_carry=True)
        bounce = (o1[alive].contiguous(), d1[alive].contiguous(),
                  t[alive].contiguous())
        for kind in (k for k, n in HITS if n == name):
            tab = getattr(scene, kind)
            nr = 3 if kind == "spheres" else 2
            for which, rays in (("primary", (o, d, t)), ("bounce", bounce)):
                launch, call = _hit_calls(kind, tab, rays[:nr], cfg.t_min)
                outs[f"hit {kind} {name} {which}"] = call()
                if which == "bounce":
                    times[f"device launch {kind} {name} bounce "
                          f"{rays[0].shape[0]}"] = device_ms(launch)
            for size in HIT_SIZES.get((kind, name), (1 << 18,)):
                launch, call = _hit_calls(
                    kind, tab, tuple(r[:size] for r in (o, d, t)[:nr]),
                    cfg.t_min)
                times[f"launch {kind} {name} {size}"] = cuda_ms(launch)
                times[f"device launch {kind} {name} {size}"] = device_ms(
                    launch)
                times[f"call {kind} {name} {size}"] = cuda_ms(call)
    for kind in ("spheres", "rects", "triangles"):
        tab, rays = checks.random_hit_case(kind, dev, 100_000)
        nr = 3 if kind == "spheres" else 2
        launch, call = _hit_calls(kind, tab, rays[:nr], 1e-3)
        outs[f"hit {kind} random"] = call()
        times[f"device launch {kind} random {tab.valid.shape[0]} rows"] = \
            device_ms(launch)


def staged_frames(dev, outs, times):
    """The staged path end to end (see the module's docstring)."""
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    cfg = RenderConfig(**FULL)
    objs, cams, bg = scenes.jumpy_balls_uvdebug(cfg.aspect_ratio)
    scene, static = build_scene(objs, background=bg)
    scene, cam = scene.to(dev), cams[0].to(dev)

    def uvdebug():
        return integrator.render_image(scene, static, cfg, cam)

    outs["render_image jumpy_balls_uvdebug"] = (uvdebug(),)
    times["render_image jumpy_balls_uvdebug"] = cuda_ms(uvdebug)
    scene, static, cams = scenes.generate_scene(
        "wavefront_cow_obj", cfg.aspect_ratio, device=dev)
    cam = cams[0].to(dev)
    chunk = 1 << 18

    def cow():
        with torch.no_grad():
            return torch.cat([integrator.render_chunk(
                scene, static, cfg, cam,
                torch.arange(s, min(s + chunk, cfg.n_rays), device=dev),
                cfg.seed) for s in range(0, cfg.n_rays, chunk)])

    outs["staged frame wavefront_cow_obj"] = (cow(),)
    times["staged frame wavefront_cow_obj 262144"] = cuda_ms(cow)


def backward_kernels(dev, outs, times):
    """K9, K7, K2 and K4, the forward+backward frames and earth's fit step
    (see the module's docstring) into `outs` and `times`."""
    import torch

    from raytracer_weekend_tpu_torch import fused_diff, integrator
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    cfg = RenderConfig(**FULL)

    def load(name):
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device=dev)
        return scene, static, cams[0].to(dev)

    grad, perm, pts, live = noise_records(dev)
    ct = torch.randn(pts.shape[0], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(10))
    launch, call = _turb_vjp_calls(grad, perm, pts, ct, live)
    d_grad, d_p = call()
    outs["K9 two_perlin_spheres d_p"] = (d_p,)
    outs["K9 two_perlin_spheres summed"] = (d_grad,)
    times["launch K9 two_perlin_spheres"] = cuda_ms(launch)
    times["call K9 two_perlin_spheres"] = cuda_ms(call)

    n = cfg.n_rays
    for kern, name in BACKWARD:
        scene, static, cam = load(name)
        defer = mk.defers(static)
        rad, _, codes, *recs = mk.render_fused(
            scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True,
            emit_deferred=defer)
        g, cabc = 2.0 * rad, None
        if defer:
            g, cabc, _ = fused_diff.combine_vjp(scene, static, recs, g, [])
        o, d, t, rid = integrator._pixel_rays(
            cam, cfg, torch.arange(n, device=dev), cfg.seed)
        ktab = rb.pack_ktab(scene).detach() if static.n_spheres else None
        ptab = (rb.pack_ptab(scene, static).detach()
                if static.n_rects + static.n_triangles else None)
        launch, call = _replay_calls((ktab, ptab, scene.background, cfg, o,
                                      d, t, rid, cfg.seed, codes, g, n), cabc)
        out = call()
        outs[f"{kern} {name} per-lane"] = out[2:5]
        outs[f"{kern} {name} summed"] = tuple(
            x for x in (out[0], out[1], out[5]) if x is not None)
        times[f"launch {kern} {name}"] = cuda_ms(launch)
        times[f"call {kern} {name}"] = cuda_ms(call)

    for name in FWD_BWD:
        times[f"fwd+bwd {name}"] = cuda_ms(_fwd_bwd(*load(name), cfg))
    scene, static, cam = load("earth")
    times["fit step earth"] = _fit_step_ms(scene, static, cfg, cam)


def _turb_vjp_calls(grad, perm, p, ct, live):
    """(the launch alone, the call) of the checkout's K9, as zero-argument
    callables on operands built beforehand; a checkout without
    `vjp_operands` is driven through its own library."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import _build
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    def call():
        return pt.turbulence_vjp(grad, perm, p, ct, 7, live)

    if hasattr(pt, "vjp_operands"):
        ops = pt.vjp_operands(grad, perm, p, ct, live)
        return (lambda: pt._launch_vjp(ops)), call
    lib = _build.load_library()
    n, pf, g, pm, lv = pt._args(grad, perm, p, live)
    c = ct.reshape(n).to(torch.float32).contiguous()
    d_p = torch.empty((n, 3), device=p.device)
    d_grad = torch.zeros((g.shape[0], 3), device=p.device)

    def launch():
        _build.check(lib, lib.rtw_turbulence_vjp(
            pf.data_ptr(), c.data_ptr(), lv.data_ptr(), g.data_ptr(),
            pm.data_ptr(), n, 7, d_p.data_ptr(), d_grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "K9 launch")
    return launch, call


def _replay_calls(args, cabc):
    """(the launch alone, the call) of the checkout's replay backward on
    `replay_bwd_fused`'s positional `args`; a checkout without `operands`
    is driven through its own library on the operands its call builds."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import _build
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    def call():
        return rb.replay_bwd_fused(*args, cabc=cabc)

    if hasattr(rb, "operands"):
        ops = rb.operands(*args, cabc=cabc)
        return (lambda: rb._launch(ops)), call
    ktab, ptab, bg, cfg, o, d, t, rid, seed, codes, g, n = args
    lib = _build.load_library()
    dev = bg.device
    S = 0 if ktab is None else ktab.shape[1]
    R = 0 if ptab is None else ptab.shape[1]
    shared = rb.shared_reductions(lib, dev, S, R)
    tabs = [None if x is None else x.detach().float().contiguous()
            for x in (ktab, ptab)]
    bg = bg.detach().float().contiguous()
    rid = rid.to(torch.int64) & 0xFFFFFFFF
    rid = torch.where(rid >= 2**31, rid - 2**32, rid).to(torch.int32)
    g = g.detach().float().contiguous()
    cabc = None if cabc is None else cabc.detach().float().contiguous()
    dtabs = [None if x is None else torch.zeros_like(x) for x in tabs]
    outs = [torch.empty((n, 3), device=dev), torch.empty((n, 3), device=dev),
            torch.empty((n,), device=dev), torch.zeros((3,), device=dev)]
    scratch = torch.empty((cfg.max_depth, 9, n), device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    def launch():
        _build.check(lib, lib.rtw_replay_bwd(
            ptr(tabs[0]), S, ptr(tabs[1]), R, int(shared[0]),
            int(shared[1]), bg.data_ptr(), o.data_ptr(), d.data_ptr(),
            t.data_ptr(), rid.data_ptr(), codes.data_ptr(), g.data_ptr(),
            ptr(cabc), int(g.dim() == 3), n, cfg.max_depth, float(cfg.t_min),
            int(seed) & 0xFFFFFFFF, scratch.data_ptr(), ptr(dtabs[0]),
            ptr(dtabs[1]), *(x.data_ptr() for x in outs),
            torch.cuda.current_stream().cuda_stream), "replay backward")
    return launch, call


def _fwd_bwd(scene, static, cam, cfg):
    """bench.py's forward+backward frame as a callable: the gradient of the
    radiance sum w.r.t. every float leaf through render_fused_diff."""
    import torch

    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    leaves = [le.detach().clone() for le in scene.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    diff_scene = SceneData.from_leaves(leaves, scene.trees)

    def fwd_bwd():
        rad = render_fused_diff(diff_scene, static, cfg, cam, 0, cfg.n_rays,
                                cfg.seed)
        return torch.autograd.grad(rad.sum(), floats)
    return fwd_bwd


def _fit_step_ms(scene, static, cfg, cam, steps=6):
    """InverseRenderer.fit on the image atlas from 0.8 of it: the median
    step after the first (module loading), host clock between synchronized
    callbacks."""
    import time

    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    start = scene._replace(textures=scene.textures._replace(
        images=scene.textures.images * 0.8))
    stamps = []

    def on_step(i, loss, sc):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    InverseRenderer(static, cfg, cam, target).fit(start, steps=steps,
                                                  callback=on_step)
    return statistics.median((b - a) * 1e3 for a, b in
                             zip(stamps[1:], stamps[2:]))


def _norm_rel(got, ref):
    """|got - ref| / |ref| in float64; max |got| where ref is all zero."""
    ref = ref.double()
    if not bool(ref.any()):
        return float(got.double().abs().max()) if got.numel() else 0.0
    return float((got.double() - ref).norm() / ref.norm())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--only", choices=("forward", "backward", "k6a",
                                       "hits"),
                    help="run one part (default: forward and backward)")
    ap.add_argument("--out", default="build/ab_render.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--save", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:  # one checkout's process
        out_dir = pathlib.Path(args.child)
        out_dir.mkdir(parents=True, exist_ok=True)
        times = run_one(out_dir, args.save, args.only, args.lib)
        (out_dir / f"times{'-saved' if args.save else ''}.json").write_text(
            json.dumps(times))
        return

    import torch

    this = pathlib.Path(__file__).resolve().parents[2]
    other = pathlib.Path(args.other).resolve()
    out = pathlib.Path(args.out).resolve()
    work = this / "build" / "ab_render"   # git-ignored; outputs are large
    runs = {}
    order = [("other", other, True), ("this", this, True),
             ("this", this, False), ("other", other, False)]
    lib = None
    if args.only == "k6a":  # and this checkout on the other's library
        lib = subprocess.run(
            [sys.executable, "-c", "from raytracer_weekend_tpu_torch.ops."
             "cuda import _build; print(_build.build())"], cwd=other,
            env=dict(os.environ, PYTHONPATH=str(other)), check=True,
            capture_output=True, text=True).stdout.strip().splitlines()[-1]
        mixed = ("this, other's library", this, False)
        order = [*order[:2], mixed, mixed, *order[2:]]
    for who, root, save in order:
        env = dict(os.environ, PYTHONPATH=str(root))
        child = work / who.replace(", ", "-").replace("'", "").replace(" ", "_")
        subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                        "--other", str(other), "--child", str(child)]
                       + (["--save"] if save else [])
                       + ([f"--only={args.only}"] if args.only else [])
                       + ([f"--lib={lib}"] if who.endswith("library") else []),
                       cwd=root, env=env, check=True)
        name = "times-saved.json" if save else "times.json"
        runs.setdefault(who, []).append(json.loads((child / name).read_text()))
    a = torch.load(work / "other" / "outputs.pt")
    b = torch.load(work / "this" / "outputs.pt")
    equal = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
             for k in a if not k.endswith(" summed")}
    summed = {k: [_norm_rel(y, x) for x, y in zip(a[k], b[k])]
              for k in a if k.endswith(" summed")}
    budget = {k: TURB_NORM_REL if k.startswith("K9") else TAB_NORM_REL
              for k in summed}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    report = dict(card=smi, other=str(other), bitwise_equal=equal,
                  summed_norm_rel=summed, summed_budget=budget,
                  ms={who: {k: [r[k] for r in rs] for k in rs[0]}
                      for who, rs in runs.items()})
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    over = [k for k, v in summed.items() if max(v) > budget[k]]
    if not all(equal.values()) or over:
        raise SystemExit(f"outputs differ: "
                         f"{[k for k, v in equal.items() if not v]}; "
                         f"beyond their budgets: {over}")


if __name__ == "__main__":
    main()
