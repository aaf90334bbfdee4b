#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's two paths on jumpy_balls at 400x225, 16 spp, depth 8,
through the entry points a user calls: the forward render
(`integrator.render_image`) and inverse rendering
(`train.InverseRenderer.fit`, forward + backward through
`fused_diff.render_fused_diff`). It builds the CUDA kernels from the sources
in the checkout and holds each against its plain torch version first.
Phases, one line each (or a few):

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build/load of the kernel library, with its build seconds;
  3. the device PCG4D against the plain torch `rand4`, bit for bit;
  4. the kernel against its plain version: two_spheres 64x36 4 spp depth 6,
     and jumpy_balls at full size (plain in 2^17-lane chunks, TF32 off),
     with the flip budgets of tests/test_megakernel.py:66-70; lane-window
     halves against the whole frame, bitwise;
  5. the forward path: render_image on the card, with the launch count
     reset just before; frame time (1 warm-up, 10 timed), segments per frame
     and segments/s; the tone-mapped PNG goes to build/.
  6. the training path: K1-emit (radiance and segments bitwise those of the
     launch without codes, codes against the plain version's), K2 against
     its plain version on the kernel's own codes with g = 2 rad, then
     InverseRenderer.fit for 3 Adam steps from color1 + 0.2 with the launch
     counts reset just before: step time, forward+backward frame time and
     segments/s, and one plain forward+backward frame.

Then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure is an uncaught exception: the
exit code is not 0 and the last line is not printed. Without a CUDA device,
or without the rest of the repository beside it, the script fails.
"""

from __future__ import annotations

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


def _budgets(got, ref, got_seg, ref_seg, n):
    """tests/test_megakernel.py:66-70 flip budgets; raise when exceeded."""
    import torch

    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    bad = int((rel > 0.05).any(dim=1).sum())
    dseg = abs(int(got_seg) - int(ref_seg))
    mean = float((got - ref).abs().mean())
    max_abs = float((got - ref).abs().max())
    finite = bool(torch.isfinite(got).all())
    ok = (finite and dseg <= max(4, n // 300) and bad <= max(4, n // 64)
          and mean < 3e-3)
    return ok, dict(lanes=n, seg_delta=dseg, seg_budget=max(4, n // 300),
                    bad_lanes=bad, bad_budget=max(4, n // 64),
                    mean_abs_err=mean, mean_budget=3e-3,
                    max_abs_err=max_abs, finite=finite)


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available to torch")
    from raytracer_weekend_tpu_torch import integrator, rng
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models.scenes import generate_scene
    from raytracer_weekend_tpu_torch.ops.cuda import _build
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.utils.image import save_png, tone_map

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
        parts = [mk.render_fused_reference(
            scene, cfg, cam, s, min(PLAIN_CHUNK, cfg.n_rays - s), cfg.seed,
            static=static) for s in range(0, cfg.n_rays, PLAIN_CHUNK)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

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
                             cfg.n_rays)
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
    integrator.render_image(scene, static, cfg, cam)        # warm-up
    torch.cuda.synchronize()
    frame_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = integrator.render_image(scene, static, cfg, cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = mk.LAUNCHES
    if launches < 1:
        raise AssertionError("render_image did not launch the CUDA kernel")
    img = img.cpu()
    if tuple(img.shape) != (cfg.height, cfg.width, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"bad image: {tuple(img.shape)}")
    # The main path's image is the kernel's lanes summed over spp.
    want = k_rad.reshape(cfg.n_pixels, cfg.samples_per_pixel, 3).sum(1)
    if not torch.equal(img.reshape(-1, 3), want.cpu()):
        raise AssertionError("render_image differs from render_fused's lanes")
    med = statistics.median(frame_ms)
    segs = int(k_seg.sum())
    out = ROOT / "build" / "chip_smoke_jumpy_balls.png"
    out.parent.mkdir(exist_ok=True)
    save_png(str(out), tone_map(img.numpy(), cfg.samples_per_pixel))
    print(f"phase 5 main path: render_image jumpy_balls {cfg.width}x"
          f"{cfg.height} spp {cfg.samples_per_pixel} depth {cfg.max_depth}"
          f" on {smi}: {launches} kernel launches, median frame {med:.3f} ms"
          f" (min {min(frame_ms):.3f}, max {max(frame_ms):.3f}), "
          f"{segs} segments/frame, {segs / (med / 1e3):.4e} segments/s; "
          f"|segments - reference {REFERENCE_SEGMENTS}| = "
          f"{abs(segs - REFERENCE_SEGMENTS)}; plain version frame "
          f"{plain_ms:.3f} ms; image -> {out.relative_to(ROOT)}", flush=True)

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
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb
    from raytracer_weekend_tpu_torch.scene.data import SceneData
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    n, seed = cfg.n_rays, cfg.seed
    dev = k_rad.device
    windows = [slice(s, min(s + PLAIN_CHUNK, n))
               for s in range(0, n, PLAIN_CHUNK)]

    # ---- 6a. K1-emit -----------------------------------------------------
    def emit_frame():
        return mk.render_fused(scene, cfg, cam, 0, n, seed, static=static,
                               emit_paths=True)

    def plain_emit_frame():
        parts = [mk.render_fused_reference(
            scene, cfg, cam, w.start, w.stop - w.start, seed, static=static,
            emit_paths=True) for w in windows]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

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
        return rb.replay_bwd_fused(ktab, bg, cfg, o, d, t, rid, seed, codes,
                                   g, n)

    def plain_bwd(c, g_):
        """replay_bwd_reference in lane windows; the table and background
        cotangents summed over them."""
        parts = [rb.replay_bwd_reference(ktab, bg, cfg, o[w], d[w], t[w],
                                         rid[w], seed, c[w], g_[w])
                 for w in windows]
        return (sum(p[0] for p in parts), torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]),
                torch.cat([p[3] for p in parts]), sum(p[4] for p in parts))

    def k2_plain():
        return plain_bwd(codes, g)

    got, ref = k2(), k2_plain()
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    k2_stats = [_agree(name, a, b, scale) for name, a, b in zip(
        ("d_ktab", "d_o", "d_d", "d_time", "d_bg"), got, ref)]
    k2_err = max(s["max_abs_err"] for s in k2_stats)
    k2_ms = _cuda_ms(k2, 5)
    k2_plain_ms = _cuda_ms(k2_plain, 3)
    print(f"phase 6 K2: {json.dumps(k2_stats)}; replay_bwd_fused frame "
          f"{k2_ms:.3f} ms, plain version {k2_plain_ms:.3f} ms (median; "
          f"{smi})", flush=True)

    # ---- 6c. the training path ---------------------------------------------
    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    start = scene._replace(textures=scene.textures._replace(
        color1=scene.textures.color1 + 0.2))
    stamps = []

    def on_step(i, loss, sc):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    mk.LAUNCHES = mk.EMIT_LAUNCHES = rb.LAUNCHES = 0
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    fitted, hist = InverseRenderer(static, cfg, cam, target).fit(
        start, steps=3, callback=on_step)
    emit_launches, k2_launches = mk.EMIT_LAUNCHES, rb.LAUNCHES
    if emit_launches < 1 or k2_launches < 1:
        raise AssertionError(f"InverseRenderer.fit launched K1-emit "
                             f"{emit_launches} and K2 {k2_launches} times")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"the loss did not drop: {hist}")
    if not all(bool(torch.isfinite(le).all()) for le in fitted.leaves()
               if le.is_floating_point()):
        raise AssertionError("non-finite parameters after fit")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    step_med = statistics.median(step_ms[1:])

    leaves = [le.detach().clone() for le in scene.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    diff_scene = SceneData.from_leaves(leaves)

    def fwd_bwd():
        """bench.py's forward+backward: the gradient of the radiance sum."""
        rad = render_fused_diff(diff_scene, static, cfg, cam, 0, n, seed)
        return torch.autograd.grad(rad.sum(), floats)

    def plain_fwd_bwd():
        """The plain forward with codes, then the plain backward on them."""
        rad, _, c = plain_emit_frame()
        return plain_bwd(c, torch.ones_like(rad))

    fwd_bwd()
    fb_ms = _cuda_ms(fwd_bwd, 5)
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


if __name__ == "__main__":
    main()
