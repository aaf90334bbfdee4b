#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls: the forward
render (`integrator.render_image`) and inverse rendering
(`train.InverseRenderer.fit`, forward + backward through
`fused_diff.render_fused_diff`), on jumpy_balls (spheres) and on
cornell_box and the cow mesh (the planar family), all at 400x225, 16 spp,
depth 8. It builds the CUDA kernels from the sources in the checkout and
holds each against its plain torch version first. Phases, one line each
(or a few):

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build/load of the kernel library, with its build seconds;
  3. the device PCG4D against the plain torch `rand4`, bit for bit;
  4. K1 against its plain version: two_spheres 64x36 4 spp depth 6,
     and jumpy_balls at full size (plain in 2^17-lane chunks, TF32 off),
     with the flip budgets of tests/test_megakernel.py:66-70; lane-window
     halves against the whole frame, bitwise;
  5. the sphere forward path: render_image on jumpy_balls, with the launch
     count reset just before; frame time (1 warm-up, 10 timed), segments
     per frame and segments/s; the tone-mapped PNG goes to build/;
  6. the sphere training path: K1-emit (radiance and segments bitwise those
     of the launch without codes, codes against the plain version's), K2
     against its plain version on the kernel's own codes with g = 2 rad,
     then InverseRenderer.fit for 3 Adam steps from color1 + 0.2 with the
     launch counts reset just before: step time, forward+backward frame
     time and segments/s, and one plain forward+backward frame;
  7. the planar forward path: K3 against its plain version with the planar
     budgets of tests/test_megakernel.py:119-128 on cornell_box (full
     size, plain in 2^17-lane windows), simple_triangle and mesh_shards
     (64x36, 4 spp, depth 6) and the cow (160x90, 4 spp, depth 8, plain in
     2^12-lane windows); then render_image on cornell_box and the cow at
     full size with the planar launch count reset just before each: frame
     time, segments per frame and segments/s, PNGs to build/;
  8. the planar training path: K3-emit on cornell_box (bitwise K3's
     radiance and segments, codes against the plain codes), K4 against its
     plain version on the kernel's own codes on cornell_box (full size,
     d(ptab) in shared memory) and the cow (reduced, d(ptab) by
     warp-aggregated global atomics), InverseRenderer.fit for 3 Adam steps
     on cornell_box from color1 + 0.2 with the counts reset just before,
     the cow's forward+backward frame through render_fused_diff at full
     size, and one simple_triangle forward+backward (uv-debug: K3-emit,
     then torch autograd of the replay, no K4).

Then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure is an uncaught exception: the
exit code is not 0 and the last line is not printed. Without a CUDA device,
or without the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# Sanity line from the reference's records: traced segments of this frame
# (jumpy_balls seed 0, 400x225, 16 spp, depth 8, render seed 0). The scene and
# the seed fix it up to near-tangent winner flips; information, not a gate.
REFERENCE_SEGMENTS = 3_747_165
PLAIN_CHUNK = 1 << 17
# K2 against its plain version, per output: relative L2 error, cosine, and
# the entries that are zero in the plain version, relative to the largest
# entry of any of its outputs.
K2_NORM_REL, K2_COS, K2_ZERO = 1e-3, 0.9999, 1e-6


# Kernel-vs-plain flip budgets (|Δsegments| <= n // seg, lanes with rel err
# > 0.05 <= n // bad, mean abs err < mean): spheres, tests/test_megakernel.py
# :66-70; the planar family, :119-128.
SPHERE_BUDGETS = dict(seg=300, bad=64, mean=3e-3)
PLANAR_BUDGETS = dict(seg=200, bad=100, mean=1e-3)


def _budgets(got, ref, got_seg, ref_seg, n, seg, bad, mean):
    """The flip budgets above -> (ok, stats)."""
    import torch

    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    n_bad = int((rel > 0.05).any(dim=1).sum())
    dseg = abs(int(got_seg) - int(ref_seg))
    err = float((got - ref).abs().mean())
    finite = bool(torch.isfinite(got).all())
    ok = (finite and dseg <= max(4, n // seg) and n_bad <= max(4, n // bad)
          and err < mean)
    return ok, dict(lanes=n, seg_delta=dseg, seg_budget=max(4, n // seg),
                    bad_lanes=n_bad, bad_budget=max(4, n // bad),
                    mean_abs_err=err, mean_budget=mean,
                    max_abs_err=float((got - ref).abs().max()),
                    finite=finite)


def _cuda_ms(fn, reps):
    """Median milliseconds of `fn()` over `reps` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _agree(name, got, ref, scale):
    """K2-vs-plain budgets for one output; raise when exceeded. `scale` is
    the largest entry of the plain version's outputs."""
    import torch

    finite = bool(torch.isfinite(got).all())
    top = float(ref.abs().max())
    err = float((got - ref).abs().max())
    zero_err = float(torch.where(ref == 0, got.abs(), 0.0).max())
    stats = dict(output=name, finite=finite, ref_max=top, max_abs_err=err,
                 zero_entries_max=zero_err)
    ok = finite and zero_err <= K2_ZERO * scale
    if top > 0.0:
        na = float(ref.norm())
        nrel = float((got - ref).norm()) / na
        cos = float((got * ref).sum()) / (na * float(got.norm()) + 1e-30)
        stats.update(norm_rel=nrel, cos=cos)
        ok = ok and nrel <= K2_NORM_REL and cos >= K2_COS
    if not ok:
        raise AssertionError(f"K2 vs plain outside budgets: {stats}")
    return stats


def plain_backward(ktab, ptab, bg, cfg, o, d, t, rid, seed, codes, g,
                   windows):
    """replay_bwd_reference in lane windows; the table and background
    cotangents summed over them."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    parts = [rb.replay_bwd_reference(ktab, ptab, bg, cfg, o[w], d[w], t[w],
                                     rid[w], seed, codes[w], g[w])
             for w in windows]

    def total(i):
        return None if parts[0][i] is None else sum(p[i] for p in parts)

    return (total(0), total(1),
            *(torch.cat([p[i] for p in parts]) for i in (2, 3, 4)), total(5))


OUTPUTS = ("d_ktab", "d_ptab", "d_o", "d_d", "d_time", "d_bg")


def agree_all(got, ref):
    """The K2/K4 budgets on every output the plain version has."""
    scale = max(float(r.abs().max()) for r in ref if r is not None)
    return [_agree(name, a, b, scale)
            for name, a, b in zip(OUTPUTS, got, ref) if b is not None]


def fit_inputs(scene, static, cfg, cam):
    """(target mean image of the scene, start scene with color1 + 0.2)."""
    from raytracer_weekend_tpu_torch import integrator

    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    start = scene._replace(textures=scene.textures._replace(
        color1=scene.textures.color1 + 0.2))
    return target, start


def fit_three_steps(static, cfg, cam, target, start):
    """3 Adam steps of InverseRenderer.fit -> (loss history, step ms by the
    host clock between synchronized callbacks); raises unless the loss fell
    and every parameter is finite."""
    import torch

    from raytracer_weekend_tpu_torch.train import InverseRenderer

    stamps = []

    def on_step(i, loss, sc):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    fitted, hist = InverseRenderer(static, cfg, cam, target).fit(
        start, steps=3, callback=on_step)
    if not hist[-1] < hist[0]:
        raise AssertionError(f"the loss did not drop: {hist}")
    if not all(bool(torch.isfinite(le).all()) for le in fitted.leaves()
               if le.is_floating_point()):
        raise AssertionError("non-finite parameters after fit")
    return hist, [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def fwd_bwd_ms(scene, static, cfg, cam):
    """bench.py's forward+backward frame: the gradient of the radiance sum
    w.r.t. every float leaf through render_fused_diff, CUDA events, median
    of 5 after a warm-up. Returns (ms, the warm-up's gradients); raises
    unless every gradient is finite."""
    import torch

    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    leaves = [le.detach().clone() for le in scene.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    diff_scene = SceneData.from_leaves(leaves)

    def fwd_bwd():
        rad = render_fused_diff(diff_scene, static, cfg, cam, 0, cfg.n_rays,
                                cfg.seed)
        return torch.autograd.grad(rad.sum(), floats)

    grads = fwd_bwd()
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("non-finite forward+backward gradients")
    return _cuda_ms(fwd_bwd, 5), grads


def time_render_image(name, scene, static, cfg, cam, k_rad):
    """The forward main path: integrator.render_image, 1 warm-up and 10
    frames timed by the host clock, synchronized. Raises unless the image
    is finite and the kernel's lanes `k_rad` summed over spp; writes the
    tone-mapped PNG to build/. Returns (frame ms, the PNG's path)."""
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.utils.image import save_png, tone_map

    integrator.render_image(scene, static, cfg, cam)        # warm-up
    frame_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = integrator.render_image(scene, static, cfg, cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    img = img.cpu()
    want = k_rad.reshape(cfg.n_pixels, cfg.samples_per_pixel, 3).sum(1)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all())
            or not torch.equal(img.reshape(-1, 3), want.cpu())):
        raise AssertionError(f"render_image({name}): bad image, or not the "
                             f"kernel's lanes summed over spp")
    out = ROOT / "build" / f"chip_smoke_{name}.png"
    out.parent.mkdir(exist_ok=True)
    save_png(str(out), tone_map(img.numpy(), cfg.samples_per_pixel))
    return frame_ms, out.relative_to(ROOT)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available to torch")
    from raytracer_weekend_tpu_torch import rng
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models.scenes import generate_scene
    from raytracer_weekend_tpu_torch.ops.cuda import _build
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    dev = torch.device("cuda", 0)
    # The plain version's matmuls must run in full f32 (TF32 flips hits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32

    # ---- 1. card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 1 card: {torch.cuda.get_device_name(dev)} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_name(lib_path.name + ".log").read_text()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"phase 2 build: {build_s:.2f} s -> {lib_path.relative_to(ROOT)}; "
          f"ptxas: {' | '.join(regs)}", flush=True)

    # ---- 3. PCG4D probe --------------------------------------------------
    import numpy as np

    ids = np.random.default_rng(20).integers(0, 2**32, size=1 << 20,
                                              dtype=np.uint64)
    ids[:4] = [0, 1, 2**31, 2**32 - 1]
    ids64 = torch.from_numpy(ids.astype(np.int64)).to(dev)
    ids32 = torch.from_numpy(ids.astype(np.uint32).view(np.int32)).to(dev)
    salts = [rng.SALT_PIXEL_JITTER, rng.SALT_LENS, rng.SALT_TIME,
             rng.SALT_LAMBERTIAN, rng.SALT_METAL, rng.SALT_DIELECTRIC,
             rng.SALT_ISOTROPIC, rng.SALT_VOLUME]
    n_cmp = 0
    for seed in (0, 0x9E3779B9):
        for salt in salts:
            for depth in (0, 7):
                got = mk.rand4_device(ids32, depth, salt, seed)
                want = rng.rand4(seed, ids64, depth, salt)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    diff = int((got != want).any(dim=1).sum())
                    raise AssertionError(
                        f"device rand4 != plain rand4 on {diff} ids "
                        f"(seed {seed:#x}, salt {salt:#x}, depth {depth})")
                n_cmp += got.numel()
    print(f"phase 3 pcg4d: device rand4 bit-equal to plain torch rand4 on "
          f"{ids.size} ray ids x 8 salts x depths {{0,7}} x 2 seeds "
          f"({n_cmp} values)", flush=True)

    # ---- 4. kernel vs plain ----------------------------------------------
    def plain_frame(scene, static, cfg, cam):
        return plain_forward(scene, static, cfg, cam, PLAIN_CHUNK)

    def kernel_frame(scene, static, cfg, cam):
        return mk.render_fused(scene, cfg, cam, 0, cfg.n_rays, cfg.seed,
                               static=static)

    results = {}
    for name, cfg in (
            ("two_spheres", RenderConfig(width=64, height=36,
                                         samples_per_pixel=4, max_depth=6)),
            ("jumpy_balls", RenderConfig(width=400, height=225,
                                         samples_per_pixel=16, max_depth=8))):
        scene, static, cams = generate_scene(name, cfg.aspect_ratio, seed=0)
        scene, cam = scene.to(dev), cams[0].to(dev)
        k_rad, k_seg = kernel_frame(scene, static, cfg, cam)
        p_rad, p_seg = plain_frame(scene, static, cfg, cam)
        torch.cuda.synchronize()
        ok, stats = _budgets(k_rad, p_rad, k_seg.sum(), p_seg.sum(),
                             cfg.n_rays, **SPHERE_BUDGETS)
        stats.update(kernel_segments=int(k_seg.sum()),
                     plain_segments=int(p_seg.sum()))
        print(f"phase 4 {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel} depth {cfg.max_depth}: "
              f"{json.dumps(stats)}", flush=True)
        if not ok:
            raise AssertionError(f"kernel vs plain outside budgets: {stats}")
        results[name] = (scene, static, cfg, cam, k_rad, k_seg, stats)

    scene, static, cfg, cam, k_rad, k_seg, jstats = results["jumpy_balls"]
    n = cfg.n_rays
    half = n // 2 + 37   # not a multiple of the block size
    a, aseg = mk.render_fused(scene, cfg, cam, 0, half, cfg.seed, static=static)
    b, bseg = mk.render_fused(scene, cfg, cam, half, n - half, cfg.seed,
                              static=static)
    if not (torch.equal(torch.cat([a, b]), k_rad)
            and torch.equal(torch.cat([aseg, bseg]), k_seg)):
        raise AssertionError("lane-window halves differ from the whole frame")
    kernel_ms = _cuda_ms(lambda: kernel_frame(scene, static, cfg, cam), 5)
    plain_ms = _cuda_ms(lambda: plain_frame(scene, static, cfg, cam), 3)
    print(f"phase 4 chunking: halves [0,{half}) + [{half},{n}) bitwise equal "
          f"to the whole frame; render_fused frame {kernel_ms:.3f} ms, plain "
          f"version frame {plain_ms:.3f} ms (median; {smi})", flush=True)

    # ---- 5. main path ----------------------------------------------------
    mk.LAUNCHES = 0
    frame_ms, png = time_render_image("jumpy_balls", scene, static, cfg, cam,
                                      k_rad)
    launches = mk.LAUNCHES
    if launches < 1:
        raise AssertionError("render_image did not launch the CUDA kernel")
    med = statistics.median(frame_ms)
    segs = int(k_seg.sum())
    print(f"phase 5 main path: render_image jumpy_balls {cfg.width}x"
          f"{cfg.height} spp {cfg.samples_per_pixel} depth {cfg.max_depth}"
          f" on {smi}: {launches} kernel launches, median frame {med:.3f} ms"
          f" (min {min(frame_ms):.3f}, max {max(frame_ms):.3f}), "
          f"{segs} segments/frame, {segs / (med / 1e3):.4e} segments/s; "
          f"|segments - reference {REFERENCE_SEGMENTS}| = "
          f"{abs(segs - REFERENCE_SEGMENTS)}; plain version frame "
          f"{plain_ms:.3f} ms; image -> {png}", flush=True)

    kernels = [{
        "name": "megakernel_sphere_forward",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": launches,
        "max_abs_err": jstats["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    kernels += training_path(scene, static, cfg, cam, k_rad, k_seg, smi)
    k3, cornell = planar_forward(dev, smi)
    kernels += [k3, planar_training(dev, smi, cornell)]

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def training_path(scene, static, cfg, cam, k_rad, k_seg, smi):
    """Phase 6; returns the kernels line's entries for K1-emit and K2."""
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    n, seed = cfg.n_rays, cfg.seed
    dev = k_rad.device
    windows = lane_windows(n, PLAIN_CHUNK)

    # ---- 6a. K1-emit -----------------------------------------------------
    def emit_frame():
        return mk.render_fused(scene, cfg, cam, 0, n, seed, static=static,
                               emit_paths=True)

    def plain_emit_frame():
        return plain_forward(scene, static, cfg, cam, PLAIN_CHUNK, emit=True)

    e_rad, e_seg, codes = emit_frame()
    p_rad, p_seg, p_codes = plain_emit_frame()
    torch.cuda.synchronize()
    if not (torch.equal(e_rad, k_rad) and torch.equal(e_seg, k_seg)):
        raise AssertionError("the emitting launch changed radiance/segments")
    for who, c, sg in (("kernel", codes, e_seg), ("plain", p_codes, p_seg)):
        nz = (c > 0).sum(1)
        if not bool(((nz == sg) | (nz == sg - 1)).all()):
            raise AssertionError(f"{who} codes: nonzero count not seg or "
                                 f"seg - 1 on some lane")
    code_lanes = int((codes != p_codes).any(1).sum())
    if code_lanes > n // 64:
        raise AssertionError(f"K1-emit codes differ from the plain version's "
                             f"on {code_lanes} lanes (budget {n // 64})")
    emit_err = float((e_rad - p_rad).abs().max())
    emit_ms = _cuda_ms(emit_frame, 5)
    plain_emit_ms = _cuda_ms(plain_emit_frame, 3)
    print(f"phase 6 K1-emit: radiance and segments bitwise equal to the "
          f"launch without codes; codes differ from the plain version's on "
          f"{code_lanes} of {n} lanes (budget {n // 64}); nonzero codes = "
          f"seg or seg - 1 on every lane; frame {emit_ms:.3f} ms, plain "
          f"{plain_emit_ms:.3f} ms (median; {smi})", flush=True)

    # ---- 6b. K2 against its plain version ----------------------------------
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, dtype=torch.int64, device=dev), seed)
    ktab = rb.pack_ktab(scene).detach()
    g = 2.0 * e_rad
    bg = scene.background

    def k2():
        return rb.replay_bwd_fused(ktab, None, bg, cfg, o, d, t, rid, seed,
                                   codes, g, n)

    def plain_bwd(c, g_):
        return plain_backward(ktab, None, bg, cfg, o, d, t, rid, seed, c, g_,
                              windows)

    def k2_plain():
        return plain_bwd(codes, g)

    got, ref = k2(), k2_plain()
    torch.cuda.synchronize()
    k2_stats = agree_all(got, ref)
    k2_err = max(s["max_abs_err"] for s in k2_stats)
    k2_ms = _cuda_ms(k2, 5)
    k2_plain_ms = _cuda_ms(k2_plain, 3)
    print(f"phase 6 K2: {json.dumps(k2_stats)}; replay_bwd_fused frame "
          f"{k2_ms:.3f} ms, plain version {k2_plain_ms:.3f} ms (median; "
          f"{smi})", flush=True)

    # ---- 6c. the training path ---------------------------------------------
    target, start = fit_inputs(scene, static, cfg, cam)
    mk.LAUNCHES = mk.EMIT_LAUNCHES = rb.LAUNCHES = 0
    hist, step_ms = fit_three_steps(static, cfg, cam, target, start)
    emit_launches, k2_launches = mk.EMIT_LAUNCHES, rb.LAUNCHES
    if emit_launches < 1 or k2_launches < 1:
        raise AssertionError(f"InverseRenderer.fit launched K1-emit "
                             f"{emit_launches} and K2 {k2_launches} times")
    step_med = statistics.median(step_ms[1:])

    def plain_fwd_bwd():
        """The plain forward with codes, then the plain backward on them."""
        rad, _, c = plain_emit_frame()
        return plain_bwd(c, torch.ones_like(rad))

    fb_ms, _ = fwd_bwd_ms(scene, static, cfg, cam)
    plain_fb_ms = _cuda_ms(plain_fwd_bwd, 1)
    segs = int(k_seg.sum())
    print(f"phase 6 training path: InverseRenderer.fit jumpy_balls "
          f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
          f"{cfg.max_depth}, 3 Adam steps from color1 + 0.2 on {smi}: "
          f"{emit_launches} K1-emit and {k2_launches} K2 launches; loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{step_med:.3f}); forward+backward frame (render_fused_diff + "
          f"autograd.grad of the sum) {fb_ms:.3f} ms, {segs / (fb_ms / 1e3):.4e}"
          f" segments/s; plain forward+backward frame {plain_fb_ms:.3f} ms",
          flush=True)
    return [{
        "name": "megakernel_sphere_forward_emit",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": emit_launches,
        "max_abs_err": emit_err,
        "ms": emit_ms,
        "plain_ms": plain_emit_ms,
    }, {
        "name": "replay_bwd_sphere",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/replay_bwd.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/replay_bwd.py:191",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }]


# ---- the planar family (phases 7 and 8) ------------------------------------

FULL = dict(width=400, height=225, samples_per_pixel=16, max_depth=8)
COW_REDUCED = dict(width=160, height=90, samples_per_pixel=4, max_depth=8)
SMALL = dict(width=64, height=36, samples_per_pixel=4, max_depth=6)
# The cow's plain version tests every lane against all 5,805 planar
# primitives at once: (B, T) planes of 2^12 lanes stay near 100 MB each.
COW_CHUNK = 1 << 12


def load_scene(name, size, dev):
    """(scene, static, cfg, cam) on `dev`: a catalog scene, or mesh_shards."""
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    cfg = RenderConfig(**size)
    if name == "mesh_shards":
        objs, cams, bg = scenes.mesh_shards(cfg.aspect_ratio)
        scene, static = build_scene(objs, background=bg)
    else:
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio)
    return scene.to(dev), static, cfg, cams[0].to(dev)


def lane_windows(n, size):
    return [slice(s, min(s + size, n)) for s in range(0, n, size)]


def plain_forward(scene, static, cfg, cam, window, emit=False):
    """render_fused_reference in lane windows, concatenated."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    parts = [mk.render_fused_reference(
        scene, cfg, cam, w.start, w.stop - w.start, cfg.seed, static=static,
        emit_paths=emit) for w in lane_windows(cfg.n_rays, window)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(len(parts[0])))


def planar_forward(dev, smi):
    """Phase 7: K3 against its plain version on four scenes, then the
    forward main path on cornell_box and the cow. Returns the kernels
    line's K3 entry and cornell_box's (scene, static, cfg, cam, rad, seg)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    failed = []
    frames = {}
    for name, size, window in (("cornell_box", FULL, PLAIN_CHUNK),
                               ("simple_triangle", SMALL, PLAIN_CHUNK),
                               ("mesh_shards", SMALL, PLAIN_CHUNK),
                               ("wavefront_cow_obj", COW_REDUCED, COW_CHUNK)):
        scene, static, cfg, cam = load_scene(name, size, dev)
        k_rad, k_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static)
        p_rad, p_seg = plain_forward(scene, static, cfg, cam, window)
        torch.cuda.synchronize()
        ok, stats = _budgets(k_rad, p_rad, k_seg.sum(), p_seg.sum(),
                             cfg.n_rays, **PLANAR_BUDGETS)
        stats.update(kernel_segments=int(k_seg.sum()),
                     plain_segments=int(p_seg.sum()))
        print(f"phase 7 K3 vs plain {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel} depth {cfg.max_depth} (plain in "
              f"{window}-lane windows): {json.dumps(stats)}", flush=True)
        if not ok:
            failed.append((name, stats))
        frames[name] = (scene, static, cfg, cam, k_rad, k_seg, window, stats)
    if failed:
        raise AssertionError(f"K3 vs plain outside budgets: {failed}")

    scene, static, cfg, cam, _, _, window, cstats = frames["cornell_box"]
    k3_ms = _cuda_ms(lambda: mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                             cfg.seed, static=static), 5)
    plain_ms = _cuda_ms(lambda: plain_forward(scene, static, cfg, cam,
                                              window), 3)
    print(f"phase 7 K3 timing cornell_box: render_fused frame {k3_ms:.3f} ms,"
          f" plain version frame {plain_ms:.3f} ms (median; {smi})",
          flush=True)

    launches = 0
    for name in ("cornell_box", "wavefront_cow_obj"):
        scene, static, cfg, cam = load_scene(name, FULL, dev)
        k_rad, k_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static)
        mk.PLANAR_LAUNCHES = 0
        frame_ms, png = time_render_image(name, scene, static, cfg, cam,
                                          k_rad)
        count = mk.PLANAR_LAUNCHES
        if count < 1:
            raise AssertionError(f"render_image({name}) did not launch K3")
        launches += count
        med = statistics.median(frame_ms)
        segs = int(k_seg.sum())
        print(f"phase 7 main path: render_image {name} {cfg.width}x"
              f"{cfg.height} spp {cfg.samples_per_pixel} depth "
              f"{cfg.max_depth} on {smi}: {count} K3 launches, median frame "
              f"{med:.3f} ms (min {min(frame_ms):.3f}, max "
              f"{max(frame_ms):.3f}), {segs} segments/frame, "
              f"{segs / (med / 1e3):.4e} segments/s; image -> {png}",
              flush=True)
        if name == "cornell_box":
            cornell = (scene, static, cfg, cam, k_rad, k_seg)
    return {
        "name": "megakernel_planar_forward",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": launches,
        "max_abs_err": cstats["max_abs_err"],
        "ms": k3_ms,
        "plain_ms": plain_ms,
    }, cornell


def planar_training(dev, smi, cornell):
    """Phase 8: K3-emit, K4 against its plain version (cornell_box at full
    size, the cow reduced), InverseRenderer.fit on cornell_box, the cow's
    forward+backward, and one uv-debug forward+backward. Returns the kernels
    line's K4 entry."""
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff
    from raytracer_weekend_tpu_torch.ops.cuda import _build
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    scene, static, cfg, cam, k_rad, k_seg = cornell
    n, seed = cfg.n_rays, cfg.seed

    # ---- 8a. K3-emit -----------------------------------------------------
    e_rad, e_seg, codes = mk.render_fused(scene, cfg, cam, 0, n, seed,
                                          static=static, emit_paths=True)
    p_rad, p_seg, p_codes = plain_forward(scene, static, cfg, cam,
                                          PLAIN_CHUNK, emit=True)
    torch.cuda.synchronize()
    if not (torch.equal(e_rad, k_rad) and torch.equal(e_seg, k_seg)):
        raise AssertionError("K3-emit changed cornell's radiance/segments")
    nz = (codes > 0).sum(1)
    if not bool(((nz == e_seg) | (nz == e_seg - 1)).all()):
        raise AssertionError("K3-emit codes: nonzero count not seg or seg-1")
    code_lanes = int((codes != p_codes).any(1).sum())
    if code_lanes > n // 100:
        raise AssertionError(f"K3-emit codes differ from the plain version's"
                             f" on {code_lanes} lanes (budget {n // 100})")
    print(f"phase 8 K3-emit cornell_box: radiance and segments bitwise K3's;"
          f" codes differ from the plain version's on {code_lanes} of {n} "
          f"lanes (budget {n // 100})", flush=True)

    # ---- 8b. K4 against its plain version --------------------------------
    lib = _build.load_library()
    limit = ctypes.c_int(0)
    _build.check(lib, lib.rtw_replay_bwd_smem_limit(ctypes.byref(limit)),
                 "cudaDeviceGetAttribute")
    k4_ms = k4_plain_ms = None
    k4_err = 0.0
    for name, size, frame in (("cornell_box", FULL, cornell),
                              ("wavefront_cow_obj", COW_REDUCED, None)):
        if frame is None:
            sc, st, cf, cm = load_scene(name, size, dev)
            rad, _, cds = mk.render_fused(sc, cf, cm, 0, cf.n_rays, cf.seed,
                                          static=st, emit_paths=True)
        else:
            sc, st, cf, cm = frame[:4]
            rad, cds = e_rad, codes
        nl = cf.n_rays
        o, d, t, rid = integrator._pixel_rays(
            cm, cf, torch.arange(nl, dtype=torch.int64, device=dev), cf.seed)
        ktab = rb.pack_ktab(sc).detach() if st.n_spheres else None
        ptab = rb.pack_ptab(sc, st).detach()
        S = 0 if ktab is None else ktab.shape[1]
        R = ptab.shape[1]
        shared = lib.rtw_replay_bwd_smem_bytes(S, R) <= limit.value
        g = 2.0 * rad
        wins = lane_windows(nl, PLAIN_CHUNK)

        def k4():
            return rb.replay_bwd_fused(ktab, ptab, sc.background, cf, o, d,
                                       t, rid, cf.seed, cds, g, nl)

        def k4_plain():
            return plain_backward(ktab, ptab, sc.background, cf, o, d, t,
                                  rid, cf.seed, cds, g, wins)

        got, ref = k4(), k4_plain()
        torch.cuda.synchronize()
        stats = agree_all(got, ref)
        k4_err = max(k4_err, max(s_["max_abs_err"] for s_ in stats))
        timing = ""
        if name == "cornell_box":
            k4_ms = _cuda_ms(k4, 5)
            k4_plain_ms = _cuda_ms(k4_plain, 3)
            timing = (f"; replay_bwd_fused frame {k4_ms:.3f} ms, plain "
                      f"version {k4_plain_ms:.3f} ms (median; {smi})")
        print(f"phase 8 K4 vs plain {name} {cf.width}x{cf.height} spp "
              f"{cf.samples_per_pixel} depth {cf.max_depth}, {S} spheres + "
              f"{R} planar, d(ptab) reduced "
              f"{'in shared memory' if shared else 'by warp-aggregated global atomics'}"
              f": {json.dumps(stats)}{timing}", flush=True)

    # ---- 8c. InverseRenderer.fit on cornell_box ----------------------------
    target, start = fit_inputs(scene, static, cfg, cam)
    mk.EMIT_LAUNCHES = mk.PLANAR_LAUNCHES = 0
    rb.LAUNCHES = rb.PLANAR_LAUNCHES = 0
    hist, step_ms = fit_three_steps(static, cfg, cam, target, start)
    k3e, k4_launches = mk.PLANAR_LAUNCHES, rb.PLANAR_LAUNCHES
    if mk.EMIT_LAUNCHES < 1 or k3e < 1 or k4_launches < 1:
        raise AssertionError(f"InverseRenderer.fit launched K3-emit {k3e} and"
                             f" K4 {k4_launches} times")
    fb_ms, _ = fwd_bwd_ms(scene, static, cfg, cam)
    segs = int(k_seg.sum())
    print(f"phase 8 training path: InverseRenderer.fit cornell_box "
          f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
          f"{cfg.max_depth}, 3 Adam steps from color1 + 0.2 on {smi}: {k3e} "
          f"K3-emit and {k4_launches} K4 launches; loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f}); forward+backward frame "
          f"{fb_ms:.3f} ms, {segs / (fb_ms / 1e3):.4e} segments/s", flush=True)

    # ---- 8d. render_fused_diff on the cow at full size ------------------------
    sc, st, cf, cm = load_scene("wavefront_cow_obj", FULL, dev)
    _, cow_seg = mk.render_fused(sc, cf, cm, 0, cf.n_rays, cf.seed, static=st)
    before = mk.PLANAR_LAUNCHES, rb.PLANAR_LAUNCHES
    cow_ms, grads = fwd_bwd_ms(sc, st, cf, cm)
    after = mk.PLANAR_LAUNCHES - before[0], rb.PLANAR_LAUNCHES - before[1]
    if min(after) < 1 or not any(bool(g.any()) for g in grads):
        raise AssertionError(f"the cow's forward+backward: {after} K3-emit "
                             f"and K4 launches, or all-zero gradients")
    segs = int(cow_seg.sum())
    print(f"phase 8 wavefront_cow_obj forward+backward (K3-emit + K4, d(ptab)"
          f" by global atomics) {cf.width}x{cf.height} spp "
          f"{cf.samples_per_pixel} depth {cf.max_depth} on {smi}: frame "
          f"{cow_ms:.3f} ms, {segs / (cow_ms / 1e3):.4e} segments/s; every "
          f"gradient finite", flush=True)

    # ---- 8e. the uv-debug dispatch ------------------------------------------
    sc, st, cf, cm = load_scene("simple_triangle", SMALL, dev)
    v1 = sc.triangles.v1.clone().requires_grad_()
    sc = sc._replace(triangles=sc.triangles._replace(v1=v1))
    before = mk.PLANAR_LAUNCHES, rb.LAUNCHES
    rad = render_fused_diff(sc, st, cf, cm, 0, cf.n_rays, cf.seed)
    (g_v1,) = torch.autograd.grad((rad * rad).sum(), (v1,))
    if (mk.PLANAR_LAUNCHES, rb.LAUNCHES) != (before[0] + 1, before[1]):
        raise AssertionError("simple_triangle did not take K3-emit and the "
                             "replay-autograd backward")
    if not (bool(torch.isfinite(g_v1).all()) and float(g_v1.abs().max()) > 0):
        raise AssertionError(f"bad uv-debug vertex gradient {g_v1}")
    print(f"phase 8 uv-debug: simple_triangle {cf.width}x{cf.height} forward "
          f"(K3-emit) + backward (torch autograd of the replay, no K4): "
          f"d loss/d v1 = {g_v1.cpu().tolist()}", flush=True)
    return {
        "name": "replay_bwd_planar",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/replay_bwd.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/replay_bwd.py:191",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
    }


if __name__ == "__main__":
    main()
