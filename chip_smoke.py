#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls: the forward
render (`integrator.render_image`) and inverse rendering
(`train.InverseRenderer.fit`, forward + backward through
`fused_diff.render_fused_diff`), on jumpy_balls (spheres), on cornell_box
and the cow mesh (the planar family), on earth, two_perlin_spheres and
simple_light (deferred image and Perlin textures) and on the media scenes,
all at 400x225, 16 spp, depth 8; then the staged path (`render_chunk`,
and `render_image` and `InverseRenderer.fit` for scenes outside the fused
megakernel) through the closest-hit kernels K10-K12. It builds the CUDA kernels from the sources in the checkout and
holds each against its plain torch version first. Phases, one line each
(or a few):

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build/load of the kernel library, with its build seconds;
  3. the device PCG4D against the plain torch `rand4`, bit for bit;
  4. K1 against its plain version: two_spheres 64x36 4 spp depth 6,
     and jumpy_balls at full size (plain in 2^17-lane chunks, TF32 off),
     with the flip budgets of tests/test_megakernel.py:66-70; lane-window
     halves, a window of 5 lanes and a second launch against the whole
     frame, bitwise; the sphere-only kernel (K1, K1-emit, K6a: persistent
     warps) as compiled: lane slots a thread, block, row limit, registers
     of its instantiations (no spills) and jumpy_balls' resident blocks;
     many_spheres (3,970 rows) with its rows in global memory bitwise the
     rows forced into shared memory, and against its plain version;
  5. the sphere forward path: render_image on jumpy_balls, with the launch
     count reset just before; frame time (1 warm-up, 10 timed), segments
     per frame and segments/s; the tone-mapped PNG goes to build/;
  6. the sphere training path: K1-emit (radiance and segments bitwise those
     of the launch without codes, codes against the plain version's), K2
     against its plain version on the kernel's own codes with g = 2 rad,
     then InverseRenderer.fit for 3 Adam steps from color1 + 0.2 with the
     launch counts reset just before: step time, forward+backward frame
     time and segments/s, and one plain forward+backward frame;
  7. the planar forward path: K3's division-free prefilter on the card
     against the exact test (a superset) and its plain twin (the same
     bits), on an adversarial set and 2^24 random cases per t_min; K3
     against its plain version with the planar budgets of
     tests/test_megakernel.py:119-128 on cornell_box (full size, plain in
     2^17-lane windows), simple_triangle, mesh_shards, the suspension
     (17,190 triangles, plain in 2^11-lane windows) and the monument
     (64x36, 4 spp, depth 6) and the cow (160x90, 4 spp, depth 8, plain in
     2^12-lane windows); then render_image on cornell_box, the cow, the
     suspension and the textured monument at full size with the planar
     launch count reset
     just before each: frame time, segments per frame and segments/s, PNGs
     to build/; and each scene's render_fused ms a launch (its K3 entry);
  8. the planar training path: K3-emit on cornell_box (bitwise K3's
     radiance and segments, codes against the plain codes), K4 against its
     plain version on the kernel's own codes on cornell_box (full size,
     d(ptab) in shared memory) and the cow (reduced, d(ptab) by
     warp-aggregated global atomics), InverseRenderer.fit for 3 Adam steps
     on cornell_box from color1 + 0.2 with the counts reset just before,
     the cow's forward+backward frame through render_fused_diff at full
     size, and one simple_triangle forward+backward (uv-debug: K3-emit,
     then torch autograd of the replay, no K4);
  9. deferred textures, forward: K8 against its plain version on 2^20
     random points and on two_perlin_spheres' real records with their live
     mask (max abs 1e-5, dead points 0); render_image on earth,
     two_perlin_spheres and simple_light at full size (K6a and the combine,
     with the launch counts reset just before) against the plain staged
     path with the budgets of tests/test_megakernel.py:322-328, their
     segments equal to those of the same
     geometry with solid textures (K1/K3); K6a's records against the plain
     version's on 64x36 frames; frame time and segments/s;
 10. deferred textures, backward: K9 against its plain version on
     two_perlin_spheres' records (norm_rel 1e-4, every dead point's d_p
     exactly 0; their live share printed), K7 against its plain version and the plain version in
     float64 (the witness) on each scene's own codes, with the combine's
     real cotangents and with random ones (K2's budgets, on the lanes left
     after HELD_OUT below), each scene's forward+backward frame
     and InverseRenderer.fit for 3 Adam steps on earth's image atlas, with
     the launch counts reset just before;
 11. constant-density media, forward: K5 against its plain version with
     the budgets of tests/test_megakernel.py:214-258 on smokey_cornell_box
     (full size) and sphere_medium (64x36), and of
     :359-381 on book2 at 160x90, 4 spp, depth 8 (its plain version alone
     would take minutes at full size); the media kernel (persistent warps,
     tables from global memory) as compiled: block, registers of its
     instantiations (no spills), each scene's resident blocks;
     render_image of smokey_cornell_box and book2 at full size with the
     launch counts reset just before (K5, and K3's book2 entry);
 12. the depth-phased render (K6b), a group of G lanes per ray: on
     bench.py's book2_criterion and jumpy_balls at depth 20, bitwise the
     single-pass launch with G forced to each of 1, 2, ..., 32 and chosen
     from the live lanes, G and live lanes per phase, deep against
     single-pass ms in turns; the criterion's main path with the launch
     count reset just before; each phase launched again from its own
     inputs: its ms, and against its plain version from the same state;
 13. media, training: K5-emit on smokey_cornell_box (bitwise K5's radiance
     and segments, codes against the plain version's), its
     forward+backward frame (K5-emit, then torch autograd of the replay:
     no kernel of the reference covers that backward), 3 Adam steps of
     InverseRenderer.fit from the media's albedo + 0.2, and book2's
     forward+backward at 400x225, 4 spp;
 14. the staged path: K12's division-free prefilter on the card against
     the exact test (a superset) and its plain twin (the same bits), on an
     adversarial set and 2^24 random cases per t_min; K11 on 1,000 random
     rects (several tiles) bit for bit its plain version and its twin, at
     t_min 1e-3, 7, 0 and -0.5; K10's, K11's and K12's launch
     configuration (rays a thread, block, tile) and their instantiations'
     registers (no spills); K10, K11 and K12 against their plain versions
     on the primary and first-bounce rays of jumpy_balls, cornell_box and
     the cow (with the share of K12's pairs that divide) and on 100k random
     rays against random tables (near-ties and lanes beyond tolerance
     counted against budgets), each timed on one scene's primary rays (the
     launch alone, the Function's call less the launch, the table's build);
     their autograd.Functions' VJP (a random cotangent on t)
     against the same route in float64, leaf by leaf, on the real rays of
     cornell_box, the cow and jumpy_balls with a uv-debug ground; the
     staged frame of the three scenes at full size in 2^18-lane chunks
     against the fused path's segments and radiance, its ms and
     segments/s, and through use_pallas=False; render_image of jumpy_balls
     with a uv-debug ground (outside the megakernel: K10) and 3 Adam steps
     of InverseRenderer.fit on it (timed; finite gradients; its loss
     rises, as through the plain brute force: the fit moves the spheres'
     geometry), 3 Adam steps on jumpy_balls with an isotropic sphere (K10,
     the loss falls); render_image and 3 Adam steps on smokey_cornell_box
     with a checker albedo (K11 and the plain medium test; the loss falls),
     each of these main-path runs with the K10-K12 counts reset just
     before; K2 on 3,970 spheres on a checker ground, d(ktab) by global
     atomics: against its plain version and float64 at 64x36x4 d6, the
     lanes on a checker cell edge held out, and against its plain version
     at full size, timed. Phase 14 takes the cow without its tree (K12);
 15. the staged path through a tree: the builder's trees of the cow, the
     monument, the suspension and book2 against the numpy builder (bit for
     bit where no split has a tied centroid, else of the same shape);
     BVH-tri and BVH-sph (csrc/bvh.cu) bit for bit the plain traverse on
     the card on 2^18 primary rays spread over each frame and their
     first-bounce rays, on those scenes, a 65-triangle mesh and jumpy_balls
     built with bvh=True, each timed beside K10/K12 on the same rays; the
     cow's staged frame in one chunk with its tree and without (K12)
     within the planar budgets;
     `python -m raytracer_weekend_tpu_torch.utils.cli wavefront_cow_obj -w
     400 -s 16 -d 8 --resume-dir D -o O` in a subprocess, then again (every
     tile read from D, the same PNG), then in this process with the counts
     reset; `--stream` on two_spheres decoded by ImageReceiver (stream_
     render's sums bit for bit, the PNG their tone map; the COBS codec's
     share of stream_render's time); the CLI's default
     route on jumpy_balls; book2's staged path through utils.debug.
     check_render_finite (BVH-sph); utils.metrics on the card
     (measured_render of the cow through render_image, the occupancy of
     jumpy_balls from the megakernel's codes and of the uv-debug jumpy from
     the staged path, profiler_trace seeing BVH-tri on the device). The
     kernels line's BVH entries are timed on the operands of the very
     launches they count, recorded as the main path made them;
 16. the render mesh (parallel/mesh, shard) on the one card: the parent
     renders the single-device references (jumpy_balls 400x225x16 d8
     through render_image and the staged path, its train gradient; the
     textured monument at 1920x1080, 4 spp, depth 8 through render_image
     and the staged path), then spawns one world after another with
     torch.multiprocessing, ranks sharing the card over gloo: jumpy on
     (4,1,1) and (2,1,1) bitwise render_image (K1 in every rank), on
     (1,2,1) within 2e-5 of the staged frame (the spp axis takes the
     staged path: K10); InverseRenderer(rmesh) on (2,1,1), its loss and
     every float leaf's gradient within 1e-4 norm-relative of the
     single-device step (K1-emit, K2); the monument on (2,1,1) bitwise
     (K3) and on (1,1,2) within tests/test_torch_bvh.py's staged budget
     (per-shard trees: BVH-tri); jumpy on an nccl world of one rank,
     bitwise. Each rank prints its backend, route, the launches of the
     main path (counts reset just before), its frame ms beside the single
     device's (both by the host clock), an instrumented frame's all_reduce
     ms (each between two synchronizations of the card) and, on a geometry
     axis, the ms of building its slice's trees. A failed rank fails the
     phase.
 17. the image-only combine pair (csrc/combine.cu) on earth.fit16's
     records (400x225, 16 spp, depth 50): the forward kernel bitwise the
     torch loop of `combine_deferred`, the VJP kernel's g_k bitwise the
     torch autograd's and the plain version's, its texel gradient within
     1e-5 relative L1 of both; each launch alone, their calls, the plain
     VJP and the torch combine they replace (forward, and under autograd
     with its texel scatter) timed; InverseRenderer.fit for 3 Adam steps on
     that frame, one launch of each a step (`image_combine_alone` runs
     this phase by itself). It runs after phase 10;

Then one JSON line describing each kernel (launches on the main path, max
abs error against its plain version, ms and plain ms, the least time the
card could take for the same work and what bounds it), each entry's ms,
launches and bound measured on the same launches: K3 one entry per scene
(cornell_box, the cow, the monument, book2), K6b one per phase of the
criterion and two (media_kernel, render_kernel) for the first phase at
G = 1 of the criterion and of the pass10 frame, K10-K12 and the BVH
kernels one per table and launch size; every entry's ms is the launch
alone on the device, on tables and operands built beforehand, its start
event queued behind a spin of the card so that the host's enqueue is left
out (`utils/timing.py` `device_ms`), its event_ms the same launch by CUDA
events around the host's call, and its wrapper_ms the call the main path
makes (render_fused, render_fused_records, replay_bwd_fused, turbulence,
turbulence_vjp, the autograd.Function) less event_ms (K6b's:
render_fused_deep less its phases' launches, an equal share a phase; null
on a row whose launch the main path does not make, whose launches are 0);
the script fails if an entry lacks a key or has no positive ms and event_ms;
and as the last line {"ok": true, "device": {...}}. Any failure is an
uncaught exception: the exit code is not 0 and the last line is not
printed. Without a CUDA device, or without the rest of the repository
beside it, the script fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

from raytracer_weekend_tpu_torch.utils.timing import (cuda_ms, device_ms,
                                                     host_ms)

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
# K7 is held to K2's budgets on the lanes whose float32 gradient is defined
# to 1e-3. Noise records give the spheres' quadratics (the radius-1000
# ground's above all) nonzero geometry cotangents, and two kinds of lane are
# held out (their cotangents zeroed), at most n // HELD_OUT of them:
# - path flips: the plain staged path traced in float64 from the same rays
#   gives other codes than the forward kernel. Hits within rounding of
#   tangency, whose derivative (through 1/sqrt(disc)) is unbounded and
#   whose side of disc = 0 each float32 version picks for itself, and the
#   forward kernel's spurious re-hits of the ground (ROADMAP Queue 3);
# - ill-conditioned lanes: the plain version in float64 (the witness)
#   moves by more than ILL_REL of the lane's largest d_o, d_d, d_time entry
#   when the lane's rays move by one float32 ulp, or the plain version in
#   float32 is that far from it. Rays nearly tangent to a sphere, where
#   1/sqrt(disc) turns the rounding of disc = hb^2 - a*c into the
#   gradient's error: each float32 version rounds its own way, and either
#   can be lucky on a lane.
HELD_OUT, ILL_REL = 100, 1e-4


# Kernel-vs-plain flip budgets (|Δsegments| <= n // seg, lanes with rel err
# > 0.05 <= n // bad, mean abs err < mean): spheres, tests/test_megakernel.py
# :66-70; the planar family, :119-128; deferred textures, :322-328; media,
# :214-258; book2, :359-381 (every bounce is a race between the mist and a
# surface, and its ground is 400 cuboids sharing edges).
SPHERE_BUDGETS = dict(seg=300, bad=64, mean=3e-3)
PLANAR_BUDGETS = dict(seg=200, bad=100, mean=1e-3)
# The deferred scenes' segments are held to :322-328's n // 200. Until the
# forward kernel's sphere test kept |o|^2 - 2 o.c apart from |c|^2 - r^2 it
# computed o - c first, and rays leaving the radius-1000 ground re-hit it
# on ~0.3% of two_perlin_spheres' and simple_light's lanes, so this budget
# was n // 50.
DEFER_BUDGETS = dict(seg=200, bad=100, mean=5e-3)
VOLUME_BUDGETS = dict(seg=200, bad=100, mean=1e-3)
BOOK2_BUDGETS = dict(seg=20, bad=100, mean=2e-2)
# book2 at BOOK2_REDUCED measured Δseg 217, 132 bad lanes and mean 5.1e-3
# of 57,600 lanes on an H100 80GB HBM3 at 700 W:
# held to about twice that, tighter than :359-381.
BOOK2_REDUCED_BUDGETS = dict(seg=100, bad=200, mean=1e-2)

# The least time the card could take for a kernel's work: the larger of its
# FP32 operations over the H100 SXM's FP32 rate outside the tensor cores and
# its bytes (each input read once, each output written once) over the HBM
# rate (published peaks at 700 W). Operations are
# counted from the CUDA sources per unit of this run's work, FP32 only
# (integer hashing, compares and selects are not counted), so the bound is
# a lower bound.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
OPS_SPHERE_TEST = 29     # one moving-sphere test: lerp 8, hb 6, cc 12, disc 3
OPS_PLANAR_TEST = 12     # one plane test: two dots, a subtraction, a division
# One medium of the volume loop: the frame change 15, the slab test 25 (or
# the sphere's roots 28), the clamps, the log and the candidate 10.
OPS_VOLUME_TEST = 50
OPS_SHADE = 60           # hit record, texture and scatter of one segment
OPS_BWD_BOUNCE = 250     # replay_bwd_kernel: recompute and chain one bounce
# perlin_turb.cu, one octave of one live point, an FMA counted as two:
# fractions and Hermite weights 18, the 8 corners 74 (a 5-operation dot and
# a weighted add each, and 18 blend and offset operations shared), the
# octave's scale 6; K9 recomputes the octaves (98) for the sign, then 263 per
# octave (24 per corner with its 3 shared-memory adds, 26 shared, d_p 21).
OPS_TURB_OCTAVE = 98
OPS_TURB_VJP_OCTAVE = 361
# Every entry of the kernels line.
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "event_ms", "wrapper_ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms"}


def bound(entry, ops, nbytes):
    """`entry` with bound_ms, bound_by and library_ms (no single PyTorch call
    computes any of these kernels' functions: null)."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    entry.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 library_ms=None)
    return entry


def forward_work(n, D, segs, S, R, emit=False, defer=False, V=0,
                 phase_lanes=0):
    """(FP32 operations, bytes) of the render_kernel launches over n lanes
    that traced `segs` segments against S spheres, R planar rows and V
    media; a phase state (60 bytes) was read or written `phase_lanes`
    times."""
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    ops = segs * (S * OPS_SPHERE_TEST + R * OPS_PLANAR_TEST
                  + V * OPS_VOLUME_TEST + OPS_SHADE)
    nbytes = (4 * (len(mk.TABLE_ROWS) * S + len(mk.PLANAR_ROWS) * R
                   + len(mk.VOL_COLS) * V + mk.PAR_SIZE) + 16 * n
              + (4 * n * D if emit else 0) + (28 * n * D if defer else 0)
              + 4 * mk.STATE_SIZE * phase_lanes)
    return ops, nbytes


def backward_work(n, D, segs, S, R, defer=False, noise=False):
    """(FP32 operations, bytes) of one replay_bwd_kernel launch: tables read
    and their cotangents written; rays, ids, codes and g (per bounce when
    deferring, with cabc for noise) read; d_o, d_d, d_time written."""
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    tables = 8 * (rb.KT * S + rb.KP * R)
    lanes = n * (32 + 4 * D + (12 * D if defer else 12)
                 + (12 * D if noise else 0) + 28)
    return segs * OPS_BWD_BOUNCE, tables + lanes + 24


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


def ptxas_registers(log):
    """['name<flags>: N regs[, spills]', ...] from the build's ptxas log; the
    template flags are the kernel's bool and int parameters in order."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                      r"(I(?:L[bi]\d+E)+E)?", ln)
        if m:
            flags = re.findall(r"L[bi](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(flags)}>" if flags else "")
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)}")
            name = None
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and int(m.group(1)) and out:
            out[-1] += f" (spills {m.group(1)} B)"
    return out


def launch_times(fn, reps=5):
    """A launch alone -> (device ms, events ms), medians of `reps`: the
    kernels line's `ms` (`timing.device_ms`: the start event queued
    behind a spin of the card, so the host's enqueue of `fn` overlaps the
    spin and is left out) and `event_ms` (`timing.cuda_ms`, which also
    holds the host's enqueue: allocations, a counter's zeroing, the ctypes
    call). An entry's `wrapper_ms` is its call less `event_ms`, both by
    events."""
    return device_ms(fn, reps), cuda_ms(fn, reps)


def launch_ms(scene, static, cfg, cam, emit=False):
    """The forward kernel's launch alone over the frame: `mk._launch` on
    the tables built beforehand (as the depth phases and the fits pass
    them) -> `launch_times`."""
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    tables = mk.build_tables(scene, static, cam)
    return launch_times(lambda: mk._launch(scene, cfg, cam, 0, cfg.n_rays,
                                           cfg.seed, static, emit_paths=emit,
                                           tables=tables))


def sphere_design(log, dev, smi):
    """The sphere-only kernel (K1, K1-emit, K6a) as compiled: its lane
    slots, block and row limit, its instantiations' registers (raises on a
    spill), and jumpy_balls' resident blocks; then many_spheres (3,970
    rows, above the limit) with its rows read from global memory (the
    default) and forced into shared memory, bitwise, and its figures
    against its plain version (information: its 0.12-radius spheres ~10
    units out flip more lanes than the budgets of jumpy_balls, through the
    K0 grouping of the sphere test, |o|^2 - 2 o.c + K0)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    regs = [r for r in ptxas_registers(log) if r.startswith("sphere_kernel")]
    if len(regs) != 8 or any("spills" in r for r in regs):
        raise AssertionError(f"sphere_kernel instantiations: {regs}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    jumpy = load_scene("jumpy_balls", SMALL, dev)[1]
    blocks = mk.resident_blocks(jumpy, dev, phase=False)
    print(f"phase 4 the sphere-only kernel as compiled: {mk.SPHERE_RAYS} "
          f"lane slots a thread, block {mk.SPHERE_BLOCK}, rows in shared "
          f"memory up to {mk.SPHERE_ROW_LIMIT}; registers (ptxas, "
          f"<emit,defer,shared>): {' | '.join(regs)}; jumpy_balls "
          f"({jumpy.n_spheres} rows): {blocks} resident blocks an SM, "
          f"{blocks * sms} blocks, "
          f"{blocks * sms * mk.SPHERE_BLOCK * mk.SPHERE_RAYS} lane slots on "
          f"{sms} SMs", flush=True)
    scene, static, cfg, cam = load_scene("many_spheres", SMALL, dev)
    tables = mk.build_tables(scene, static, cam)
    outs = [mk._launch(scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static,
                       tables=tables, resident=r) for r in (None, True)]
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    p_rad, p_seg = mk.render_fused_reference(scene, cfg, cam, 0, cfg.n_rays,
                                             cfg.seed, static=static)
    _, stats = _budgets(outs[0][0], p_rad, outs[0][1].sum(), p_seg.sum(),
                        cfg.n_rays, **SPHERE_BUDGETS)
    print(f"phase 4 many_spheres {cfg.width}x{cfg.height} spp "
          f"{cfg.samples_per_pixel} depth {cfg.max_depth} ({static.n_spheres}"
          f" rows): global rows bitwise the rows forced into shared memory "
          f"({mk.resident_blocks(static, dev, phase=False)} resident blocks "
          f"an SM with global rows): {same}; vs plain (information) "
          f"{json.dumps(stats)}", flush=True)
    if not (same and stats["finite"]):
        raise AssertionError(f"many_spheres: bitwise {same}, {stats}")


def _agree(name, got, ref, scale, check=True):
    """K2-vs-plain budgets for one output; raise when exceeded, or with
    `check` false return the stats with `ok`. `scale` is the largest entry
    of the plain version's outputs."""
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
    if check and not ok:
        raise AssertionError(f"K2 vs plain outside budgets: {stats}")
    return dict(stats, ok=ok)


def plain_backward(ktab, ptab, bg, cfg, o, d, t, rid, seed, codes, g,
                   windows, cabc=None, dtype=None):
    """replay_bwd_reference in lane windows (in `dtype`, float64 for the
    witness; the inputs' float32 by default); the table and background
    cotangents summed over them."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    def cast(x):
        return x if x is None or dtype is None else x.to(dtype)

    ktab, ptab, bg, o, d, t, g, cabc = map(cast, (ktab, ptab, bg, o, d, t, g,
                                                  cabc))
    parts = [rb.replay_bwd_reference(ktab, ptab, bg, cfg, o[w], d[w], t[w],
                                     rid[w], seed, codes[w], g[w],
                                     None if cabc is None else cabc[w])
             for w in windows]

    def total(i):
        return None if parts[0][i] is None else sum(p[i] for p in parts)

    return (total(0), total(1),
            *(torch.cat([p[i] for p in parts]) for i in (2, 3, 4)), total(5))


OUTPUTS = ("d_ktab", "d_ptab", "d_o", "d_d", "d_time", "d_bg")


def agree_all(got, ref, check=True):
    """The K2/K4 budgets on every output the plain version has."""
    scale = max(float(r.abs().max()) for r in ref if r is not None)
    return [_agree(name, a, b, scale, check)
            for name, a, b in zip(OUTPUTS, got, ref) if b is not None]


def fit_inputs(scene, static, cfg, cam):
    """(target mean image of the scene, start scene with color1 + 0.2)."""
    from raytracer_weekend_tpu_torch import integrator

    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    start = scene._replace(textures=scene.textures._replace(
        color1=scene.textures.color1 + 0.2))
    return target, start


def fit_three_steps(static, cfg, cam, target, start, falling=True):
    """3 Adam steps of InverseRenderer.fit -> (loss history, step ms by the
    host clock between synchronized callbacks); raises unless every
    parameter is finite and (with `falling`) the loss fell."""
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
    if falling and not hist[-1] < hist[0]:
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
    diff_scene = SceneData.from_leaves(leaves, scene.trees)

    def fwd_bwd():
        rad = render_fused_diff(diff_scene, static, cfg, cam, 0, cfg.n_rays,
                                cfg.seed)
        return torch.autograd.grad(rad.sum(), floats)

    grads = fwd_bwd()
    bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"non-finite forward+backward gradients: float "
                             f"leaves {bad} of {len(grads)}")
    return cuda_ms(fwd_bwd, 5), grads


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
    print(f"phase 2 build: {build_s:.2f} s -> {lib_path.relative_to(ROOT)}; "
          f"ptxas: {' | '.join(ptxas_registers(log))}", flush=True)

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
    small = mk.render_fused(scene, cfg, cam, 1001, 5, cfg.seed, static=static)
    again = kernel_frame(scene, static, cfg, cam)
    if not (torch.equal(small[0], k_rad[1001:1006])
            and torch.equal(small[1], k_seg[1001:1006])
            and torch.equal(again[0], k_rad) and torch.equal(again[1], k_seg)):
        raise AssertionError("a 5-lane window or a second launch differs")
    kernel_ms = cuda_ms(lambda: kernel_frame(scene, static, cfg, cam), 5)
    k1_ms, k1_ev = launch_ms(scene, static, cfg, cam)
    plain_ms = cuda_ms(lambda: plain_frame(scene, static, cfg, cam), 3)
    print(f"phase 4 chunking: halves [0,{half}) + [{half},{n}), a window of "
          f"5 lanes and a second launch bitwise equal to the whole frame; "
          f"render_fused frame {kernel_ms:.3f} ms, the launch alone "
          f"{k1_ms:.3f} ms on the device ({k1_ev:.3f} by events), plain "
          f"version frame {plain_ms:.3f} ms (median; {smi})", flush=True)
    sphere_design(log, dev, smi)

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

    S = scene.spheres.c0.shape[0]
    kernels = [bound({
        "name": "megakernel_sphere_forward",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": launches,
        "max_abs_err": jstats["max_abs_err"],
        "ms": k1_ms,
        "event_ms": k1_ev,
        "wrapper_ms": kernel_ms - k1_ev,
        "plain_ms": plain_ms,
    }, *forward_work(n, cfg.max_depth, segs, S, 0))]
    kernels += training_path(scene, static, cfg, cam, k_rad, k_seg, smi)
    k3, cornell = planar_forward(dev, smi)
    kernels += [*k3, planar_training(dev, smi, cornell)]
    k6a, k8, frames = deferred_forward(dev, smi)
    kernels += [k6a, k8, *deferred_training(dev, smi, frames)]
    kernels += image_combine_phase(dev, smi)
    k5, k3_book2, smokey = volume_forward(dev, smi, log)
    kernels += [k5, k3_book2, *deep_phases(dev, smi)]
    volume_training(dev, smi, smokey)
    kernels += staged_path(dev, smi)
    kernels += bvh_phase(dev, smi, log)
    mesh_phase(smi)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    missing = [(k["name"], sorted(KERNEL_KEYS - k.keys())) for k in kernels
               if KERNEL_KEYS - k.keys()]
    if missing:
        raise AssertionError(f"kernels line entries without {missing}")
    untimed = [k["name"] for k in kernels
               if not all(isinstance(k[x], float) and k[x] > 0.0
                          for x in ("ms", "event_ms"))]
    if untimed:
        raise AssertionError(f"kernels line entries without a positive ms "
                             f"and event_ms: {untimed}")
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
    emit_ms = cuda_ms(emit_frame, 5)
    emit_launch_ms, emit_ev = launch_ms(scene, static, cfg, cam, emit=True)
    plain_emit_ms = cuda_ms(plain_emit_frame, 3)
    print(f"phase 6 K1-emit: radiance and segments bitwise equal to the "
          f"launch without codes; codes differ from the plain version's on "
          f"{code_lanes} of {n} lanes (budget {n // 64}); nonzero codes = "
          f"seg or seg - 1 on every lane; frame {emit_ms:.3f} ms, the launch "
          f"alone {emit_launch_ms:.3f} ms on the device ({emit_ev:.3f} by "
          f"events), plain {plain_emit_ms:.3f} ms "
          f"(median; {smi})", flush=True)

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
    k2_ops = rb.operands(ktab, None, bg, cfg, o, d, t, rid, seed, codes, g,
                         n)
    k2_ms, k2_ev = launch_times(lambda: rb._launch(k2_ops))
    k2_call_ms = cuda_ms(k2, 5)
    k2_plain_ms = cuda_ms(k2_plain, 3)
    print(f"phase 6 K2: {json.dumps(k2_stats)}; the launch alone "
          f"{k2_ms:.3f} ms ({k2_ev:.3f} by events), replay_bwd_fused "
          f"{k2_call_ms:.3f} ms, plain version {k2_plain_ms:.3f} ms "
          f"(median; {smi})", flush=True)

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
    plain_fb_ms = cuda_ms(plain_fwd_bwd, 1)
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
    S, D = ktab.shape[1], cfg.max_depth
    return [bound({
        "name": "megakernel_sphere_forward_emit",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": emit_launches,
        "max_abs_err": emit_err,
        "ms": emit_launch_ms,
        "event_ms": emit_ev,
        "wrapper_ms": emit_ms - emit_ev,
        "plain_ms": plain_emit_ms,
    }, *forward_work(n, D, segs, S, 0, emit=True)), bound({
        "name": "replay_bwd_sphere",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/replay_bwd.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/replay_bwd.py:191",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "event_ms": k2_ev,
        "wrapper_ms": k2_call_ms - k2_ev,
        "plain_ms": k2_plain_ms,
    }, *backward_work(n, D, segs, S, 0))]


# ---- the planar family (phases 7 and 8) ------------------------------------

FULL = dict(width=400, height=225, samples_per_pixel=16, max_depth=8)
COW_REDUCED = dict(width=160, height=90, samples_per_pixel=4, max_depth=8)
SMALL = dict(width=64, height=36, samples_per_pixel=4, max_depth=6)
# The cow's plain version tests every lane against all 5,805 planar
# primitives at once: (B, T) planes of 2^12 lanes stay near 100 MB each;
# the suspension's 17,190 triangles take 2^11-lane windows for the same.
COW_CHUNK = 1 << 12
SUSPENSION_CHUNK = 1 << 11


def load_scene(name, size, dev):
    """(scene, static, cfg, cam) on `dev`: a catalog scene, or one of the
    test scenes of `models.scenes` (mesh_shards, sphere_medium,
    many_spheres, jumpy_balls_uvdebug, smokey_checker_medium)."""
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    cfg = RenderConfig(**size)
    if name not in scenes.SCENES:
        objs, cams, bg = getattr(scenes, name)(cfg.aspect_ratio)
        scene, static = build_scene(objs, background=bg)
    else:
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device=dev)
    return scene.to(dev), static, cfg, cams[0].to(dev)


def lane_windows(n, size):
    return [slice(s, min(s + size, n)) for s in range(0, n, size)]


def plain_forward(scene, static, cfg, cam, window, emit=False,
                  records=False):
    """render_fused_reference (with `records`, records_reference: the
    kernel's own outputs before any combine) in lane windows, concatenated."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    fn = mk.records_reference if records else mk.render_fused_reference
    parts = [fn(scene, cfg, cam, w.start, w.stop - w.start, cfg.seed,
                static=static, emit_paths=emit)
             for w in lane_windows(cfg.n_rays, window)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(len(parts[0])))


def candidate_check(dev):
    """The kernel's division-free planar prefilter (plane_candidate in
    csrc/megakernel.cuh) against the exact test on the card: for each t_min
    of checks.CAND_T_MINS, its adversarial set plus 2^24 random cases; it
    must pass every row the exact test accepts, and give its plain twin's
    bits on every case."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import checks
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    out = []
    for t_min in checks.CAND_T_MINS:
        cases = [torch.from_numpy(x).to(dev) for x in
                 checks.candidate_cases(t_min, 1 << 24, seed=11)]
        num, den, best = cases
        got = mk.plane_candidate_device(num, den, best, t_min)
        exact = checks.exact_accepts(num, den, best, t_min)
        twin = mk.plane_candidate_plain(*(x.cpu() for x in (num, den)),
                                        t_min, best.cpu())
        missed = int((exact & ~got).sum())
        differ = int((got.cpu() != twin).sum())
        out.append(dict(t_min=t_min, cases=num.numel(),
                        exact=int(exact.sum()), passed=int(got.sum()),
                        missed=missed, differ_from_twin=differ))
        if missed or differ:
            raise AssertionError(f"plane_candidate: {out[-1]}")
    print(f"phase 7 K3's planar prefilter on the card, adversarial cases + "
          f"2^24 random ones per t_min: a superset of the exact test, its "
          f"plain twin's bits: {json.dumps(out)}", flush=True)


def planar_forward(dev, smi):
    """Phase 7: K3 against its plain version on six scenes, then the
    forward main path on cornell_box, the cow, the suspension and the
    monument. Returns the
    kernels line's K3 entries, one a scene, and cornell_box's (scene,
    static, cfg, cam, rad, seg)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    candidate_check(dev)
    failed = []
    frames = {}
    for name, size, window in (("cornell_box", FULL, PLAIN_CHUNK),
                               ("simple_triangle", SMALL, PLAIN_CHUNK),
                               ("mesh_shards", SMALL, PLAIN_CHUNK),
                               ("wavefront_cow_obj", COW_REDUCED, COW_CHUNK),
                               ("wavefront_suspension_obj", SMALL,
                                SUSPENSION_CHUNK),
                               ("textured_monument", SMALL, COW_CHUNK)):
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

    k3 = []
    for name in ("cornell_box", "wavefront_cow_obj",
                 "wavefront_suspension_obj", "textured_monument"):
        scene, static, cfg, cam = load_scene(name, FULL, dev)
        k_rad, k_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static)
        mk.PLANAR_LAUNCHES = 0
        frame_ms, png = time_render_image(name, scene, static, cfg, cam,
                                          k_rad)
        count = mk.PLANAR_LAUNCHES
        if count < 1:
            raise AssertionError(f"render_image({name}) did not launch K3")
        med = statistics.median(frame_ms)
        segs = int(k_seg.sum())
        print(f"phase 7 main path: render_image {name} {cfg.width}x"
              f"{cfg.height} spp {cfg.samples_per_pixel} depth "
              f"{cfg.max_depth} on {smi}: {count} K3 launches, median frame "
              f"{med:.3f} ms (min {min(frame_ms):.3f}, max "
              f"{max(frame_ms):.3f}), {segs} segments/frame, "
              f"{segs / (med / 1e3):.4e} segments/s; image -> {png}",
              flush=True)
        # The plain version at full size: cornell_box's, in windows; the
        # cow, the suspension and the monument would take minutes (their
        # plain check above is at a reduced size, whose error the entry
        # carries).
        plain = None
        if name == "cornell_box":
            def plain():
                return plain_forward(scene, static, cfg, cam, PLAIN_CHUNK)
        k3.append(k3_entry(name, scene, static, cfg, cam, k_seg, count,
                           frames[name][-1]["max_abs_err"], plain, smi))
        if name == "cornell_box":
            cornell = (scene, static, cfg, cam, k_rad, k_seg)
    return k3, cornell


def k3_entry(name, scene, static, cfg, cam, k_seg, launches, err, plain,
             smi):
    """The kernels line's K3 entry for one scene at its size: ms and
    event_ms the launch alone (`launch_times`), wrapper_ms render_fused's
    call less event_ms (CUDA events, medians of 5), `launches` the scene's
    render_image count, the bound from its own segments, spheres, planar
    rows and media; `plain` (or None) times the plain version once."""
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    call_ms = cuda_ms(lambda: mk.render_fused(scene, cfg, cam, 0,
                                               cfg.n_rays, cfg.seed,
                                               static=static, deep=False), 5)
    ms, ev = launch_ms(scene, static, cfg, cam)
    plain_ms = None if plain is None else cuda_ms(plain, 1)
    R = static.n_rects + static.n_triangles
    blocks = mk.resident_blocks(static, scene.device, phase=False)
    kernel = (f"render_kernel, {mk.BLOCK} threads and {mk.TILE_BYTES} B of "
              f"planar tiles a block"
              if mk.fused_kernel(R, static.n_volumes, False) == "render_kernel"
              else f"media_kernel, {mk.MEDIA_BLOCK} threads a block")
    print(f"phase K3 timing {name} {cfg.width}x{cfg.height} spp "
          f"{cfg.samples_per_pixel} depth {cfg.max_depth} ({static.n_spheres}"
          f" spheres, {R} planar rows, {static.n_volumes} media): "
          f"render_fused {call_ms:.3f} ms a call, the launch alone "
          f"{ms:.3f} ms on the device ({ev:.3f} by events), plain "
          f"{'not timed' if plain_ms is None else f'{plain_ms:.3f} ms'}; "
          f"{blocks} resident blocks an SM of {kernel} (median; {smi})",
          flush=True)
    return bound({
        "name": f"megakernel_planar_forward[{name}]",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "event_ms": ev,
        "wrapper_ms": call_ms - ev,
        "plain_ms": plain_ms,
    }, *forward_work(cfg.n_rays, cfg.max_depth, int(k_seg.sum()),
                     static.n_spheres, R, V=static.n_volumes,
                     defer=mk.defers(static)))


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
    k4_ms = k4_ev = k4_call_ms = k4_plain_ms = k4_work = None
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
            k4_ops = rb.operands(ktab, ptab, sc.background, cf, o, d, t, rid,
                                 cf.seed, cds, g, nl)
            k4_ms, k4_ev = launch_times(lambda: rb._launch(k4_ops))
            k4_call_ms = cuda_ms(k4, 5)
            k4_plain_ms = cuda_ms(k4_plain, 3)
            k4_work = backward_work(nl, cf.max_depth, int(k_seg.sum()), S, R)
            timing = (f"; the launch alone {k4_ms:.3f} ms ({k4_ev:.3f} "
                      f"by events), "
                      f"replay_bwd_fused {k4_call_ms:.3f} ms, plain version "
                      f"{k4_plain_ms:.3f} ms (median; {smi})")
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
    return bound({
        "name": "replay_bwd_planar",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/replay_bwd.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/replay_bwd.py:191",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": k4_ms,
        "event_ms": k4_ev,
        "wrapper_ms": k4_call_ms - k4_ev,
        "plain_ms": k4_plain_ms,
    }, *k4_work)



# ---- deferred image and Perlin textures (phases 9 and 10) --------------------

DEFERRED = ("earth", "two_perlin_spheres", "simple_light")
RECORDS_SIZE = dict(width=64, height=36, samples_per_pixel=16, max_depth=8)
TURB_ABS, TURB_NORM_REL = 1e-5, 1e-4
TURB_WINDOW = 1 << 21     # points per window of the turbulence's plain twin


def plain_staged(scene, static, cfg, cam, window):
    """The staged path with inline noise and image texels (the deferred
    render's semantic reference), with the plain brute-force closest hit,
    in lane windows -> (radiance, segments)."""
    import dataclasses

    return staged_frame(scene, static, dataclasses.replace(
        cfg, use_pallas=False), cam, window)


def staged_frame(scene, static, cfg, cam, chunk):
    """The staged path over the whole frame in lane chunks (render_chunk's
    rays and `trace_lanes`, which also counts segments; its closest hit as
    `cfg.use_pallas` selects) -> (radiance, segments)."""
    import torch

    from raytracer_weekend_tpu_torch import integrator

    parts = []
    for w in lane_windows(cfg.n_rays, chunk):
        ids = torch.arange(w.start, w.stop, device=scene.device)
        o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
        parts.append(integrator.trace_lanes(scene, static, cfg, o, d, t, rid,
                                            cfg.seed))
    return tuple(torch.cat([p[i] for p in parts]) for i in (0, 1))


def noise_points(scene, dcode, abc):
    """The turbulence's inputs in the combine: every record's abc (n*D, 3)
    and its live mask, the records that defer a noise texel."""
    from raytracer_weekend_tpu_torch import textures

    tid = (dcode.abs() - 1).clamp_min(0).long()
    live = (dcode != 0) & (scene.textures.ttype[tid] == textures.NOISE)
    return abc.reshape(-1, 3), live.reshape(-1)


def brief(stats):
    """{output: [norm_rel, cos]} of agree_all's stats, nonzero outputs."""
    return {s["output"]: [s["norm_rel"], s["cos"]] for s in stats
            if "norm_rel" in s}


def norm_rel(got, ref):
    """|got - ref| / |ref| in float64."""
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm())


def ill_lanes(ref, wit):
    """(n,) bool: the lanes whose per-lane outputs (d_o, d_d, d_time) the
    float32 plain version `ref` and the float64 witness `wit` give apart
    by more than ILL_REL of the lane's largest entry (plus K2_ZERO of the
    largest entry of any lane)."""
    import torch

    def lanes(r):
        return torch.cat([r[2].double(), r[3].double(), r[4].double()[:, None]],
                         dim=1)

    w = lanes(wit)
    top = w.abs().amax(dim=1)
    err = (lanes(ref) - w).abs().amax(dim=1)
    return err > ILL_REL * top + K2_ZERO * float(top.max())


def float64_codes(scene, static, cfg, o, d, t, rid, windows):
    """The winner codes of the plain staged path (the plain brute-force
    closest hit) traced in float64 from the same rays, in lane windows."""
    import dataclasses

    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    scene64 = SceneData.from_leaves(
        [le.double() if le.is_floating_point() else le
         for le in scene.leaves()], scene.trees)
    cfg = dataclasses.replace(cfg, use_pallas=False)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        parts = [integrator.trace_lanes(
            scene64, static, cfg, o[w].double(), d[w].double(),
            t[w].double(), rid[w], cfg.seed, emit_paths=True,
            emit_deferred=mk.defers(static))[2] for w in windows]
    finally:
        torch.set_default_dtype(prev)
    return torch.cat(parts)


def turb_plain(grad, perm, p, live):
    """K8's plain version in windows of TURB_WINDOW points."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    return torch.cat([pt.turbulence_reference(grad, perm, p[w], 7, live[w])
                      for w in lane_windows(p.shape[0], TURB_WINDOW)])


def turb_vjp_plain(grad, perm, p, ct, live):
    """K9's plain version in windows: d_grad summed, d_p concatenated."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    parts = [pt.turbulence_vjp_reference(grad, perm, p[w], ct[w], 7, live[w])
             for w in lane_windows(p.shape[0], TURB_WINDOW)]
    return sum(q[0] for q in parts), torch.cat([q[1] for q in parts])


def deferred_forward(dev, smi):
    """Phase 9: K8 against its plain version (random points; the real
    records of two_perlin_spheres with their live mask), the deferred
    forward path on earth, two_perlin_spheres and simple_light at full size
    (render_image through K6a and the combine against the plain staged
    path, with the launch counts reset just before), and K6a's records
    against the plain version's on 64x36 frames. Returns the kernels line's
    K6a and K8 entries and each scene's (scene, static, cfg, cam, rad,
    seg)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    # ---- 9a. K8 against its plain version -----------------------------------
    scene, static, cfg, cam = load_scene("two_perlin_spheres", FULL, dev)
    grad, perm = scene.textures.perlin_grad, scene.textures.perlin_perm
    gen = torch.Generator(device=dev).manual_seed(9)
    p = torch.randn((1 << 20, 3), device=dev, generator=gen) * 7.0
    rand_err = float((pt.turbulence(grad, perm, p)
                      - pt.turbulence_reference(grad, perm, p)).abs().max())
    _, _, ctb, abc, dcode = mk.render_fused_records(
        scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static)
    pts, live = noise_points(scene, dcode, abc)
    got = pt.turbulence(grad, perm, pts, 7, live)
    ref = turb_plain(grad, perm, pts, live)
    torch.cuda.synchronize()
    real_err = float((got - ref).abs().max())
    dead_zero = bool((got[~live] == 0).all())
    n_live = int(live.sum())
    print(f"phase 9 K8 vs plain: 2^20 random points max abs {rand_err:.3e}; "
          f"two_perlin_spheres' records {pts.shape[0]} points, {n_live} live:"
          f" max abs {real_err:.3e}, dead points 0: {dead_zero} (budget "
          f"{TURB_ABS})", flush=True)
    if not (rand_err <= TURB_ABS and real_err <= TURB_ABS and dead_zero):
        raise AssertionError("K8 vs plain outside budgets")
    k8_ops = pt.turbulence_operands(grad, perm, pts, live)
    k8_ms, k8_ev = launch_times(lambda: pt._launch_turbulence(k8_ops))
    k8_call_ms = cuda_ms(lambda: pt.turbulence(grad, perm, pts, 7, live), 5)
    k8_plain_ms = cuda_ms(lambda: turb_plain(grad, perm, pts, live), 1)
    k8_err = max(rand_err, real_err)
    # Bytes: a live point reads p; every point reads its mask byte and writes
    # its turbulence; the tables (6 KB) are read once.
    k8_work = (n_live * 7 * OPS_TURB_OCTAVE,
               n_live * 12 + pts.shape[0] * 5 + 6144)

    # ---- 9b. the forward main path on the three scenes ----------------------
    frames, failed = {}, []
    k6a_launches = k8_launches = 0
    k6a_err = 0.0
    for name in DEFERRED:
        scene, static, cfg, cam = load_scene(name, FULL, dev)
        k_rad, k_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static)
        p_rad, p_seg = plain_staged(scene, static, cfg, cam, PLAIN_CHUNK)
        # The same geometry with solid textures takes K1/K3 (no deferral).
        solid = scene._replace(textures=scene.textures._replace(
            ttype=torch.zeros_like(scene.textures.ttype)))
        _, s_seg = mk.render_fused(solid, cfg, cam, 0, cfg.n_rays, cfg.seed,
                                   static=type(static)(**{
                                       **static.__dict__, "has_noise": False,
                                       "has_image": False}))
        torch.cuda.synchronize()
        ok, stats = _budgets(k_rad, p_rad, k_seg.sum(), p_seg.sum(),
                             cfg.n_rays, **DEFER_BUDGETS)
        same_paths = bool(torch.equal(k_seg, s_seg))
        ok = ok and same_paths
        stats.update(kernel_segments=int(k_seg.sum()),
                     plain_segments=int(p_seg.sum()),
                     segments_equal_solid_twin=same_paths)
        print(f"phase 9 K6a + combine vs the plain staged path {name} "
              f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
              f"{cfg.max_depth}: {json.dumps(stats)}", flush=True)
        if not ok:
            failed.append((name, stats))
        k6a_err = max(k6a_err, stats["max_abs_err"])
        mk.DEFER_LAUNCHES = pt.TURB_LAUNCHES = 0
        frame_ms, png = time_render_image(name, scene, static, cfg, cam,
                                          k_rad)
        launches, turbs = mk.DEFER_LAUNCHES, pt.TURB_LAUNCHES
        want_turb = static.has_noise and not static.defer_single_hit
        if launches < 1 or (want_turb and turbs < 1):
            raise AssertionError(f"render_image({name}) launched K6a "
                                 f"{launches} and K8 {turbs} times")
        k6a_launches += launches
        k8_launches += turbs
        fused_ms = cuda_ms(lambda: mk.render_fused(
            scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static), 5)
        med = statistics.median(frame_ms)
        segs = int(k_seg.sum())
        print(f"phase 9 main path: render_image {name} {cfg.width}x"
              f"{cfg.height} spp {cfg.samples_per_pixel} depth "
              f"{cfg.max_depth} on {smi}: {launches} K6a and {turbs} K8 "
              f"launches, median frame {med:.3f} ms (min {min(frame_ms):.3f},"
              f" max {max(frame_ms):.3f}), {segs} segments/frame, "
              f"{segs / (med / 1e3):.4e} segments/s; render_fused (K6a + "
              f"combine) {fused_ms:.3f} ms by CUDA events; image -> {png}",
              flush=True)
        frames[name] = (scene, static, cfg, cam, k_rad, k_seg)
    if failed:
        raise AssertionError(f"K6a + combine vs plain outside budgets: "
                             f"{failed}")

    # ---- 9c. K6a's records against the plain version's, 64x36 ---------------
    for name in DEFERRED:
        scene, static, cfg, cam = load_scene(name, RECORDS_SIZE, dev)
        n = cfg.n_rays
        _, _, codes, ctb, abc, dcode = mk.render_fused_records(
            scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True)
        _, _, r_codes, r_ctb, r_abc, r_dcode = plain_forward(
            scene, static, cfg, cam, PLAIN_CHUNK, emit=True, records=True)
        torch.cuda.synchronize()
        same = (codes == r_codes).all(dim=1)
        live = (dcode != 0) & same[:, None]
        # Far grazing ground hits (t of hundreds along a short scattered
        # direction) move by up to hundreds of units between the two
        # quadratics; hit points are compared at 1e-3 with a 2% budget.
        far = int((~torch.isclose(abc[live], r_abc[live], rtol=1e-3,
                                  atol=1e-3).all(-1)).sum())
        ctb_far = int((~torch.isclose(ctb[same], r_ctb[same], rtol=1e-4,
                                      atol=1e-4).all(-1)).any(-1).sum())
        stats = dict(lanes=n, code_lanes_differ=int((~same).sum()),
                     dcode_equal=bool(torch.equal(dcode[same], r_dcode[same])),
                     live_records=int(live.sum()), abc_far=far,
                     abc_max_abs=float((abc[live] - r_abc[live]).abs().max()),
                     ctb_lanes_far=ctb_far,
                     dead_abc_zero=bool((abc[dcode == 0] == 0).all()))
        print(f"phase 9 K6a records vs plain {name} {cfg.width}x{cfg.height}"
              f" spp {cfg.samples_per_pixel} depth {cfg.max_depth}: "
              f"{json.dumps(stats)}", flush=True)
        if not (stats["code_lanes_differ"] <= max(4, n // 100)
                and stats["dcode_equal"] and stats["dead_abc_zero"]
                and far <= max(4, stats["live_records"] // 50)
                and ctb_far <= max(4, n // 100)):
            raise AssertionError(f"K6a records vs plain: {stats}")

    # K6a (no combine) on two_perlin_spheres: the launch alone and
    # render_fused_records' call; and its plain version.
    scene, static, cfg, cam, _, k_seg = frames["two_perlin_spheres"]
    k6a_call_ms = cuda_ms(lambda: mk.render_fused_records(
        scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static), 5)
    k6a_ms, k6a_ev = launch_ms(scene, static, cfg, cam)
    k6a_plain_ms = cuda_ms(lambda: plain_forward(
        scene, static, cfg, cam, PLAIN_CHUNK, records=True), 1)
    print(f"phase 9 timing two_perlin_spheres: K6a's launch alone "
          f"{k6a_ms:.3f} ms on the device ({k6a_ev:.3f} by events), "
          f"render_fused_records {k6a_call_ms:.3f} ms, plain "
          f"{k6a_plain_ms:.3f} ms; K8 on the frame's {pts.shape[0]} "
          f"records: the launch alone {k8_ms:.3f} ms ({k8_ev:.3f}), "
          f"turbulence {k8_call_ms:.3f} ms, plain {k8_plain_ms:.3f} ms "
          f"(median; {smi})", flush=True)
    k6a = bound({
        "name": "megakernel_deferred_records",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": k6a_launches,
        "max_abs_err": k6a_err,
        "ms": k6a_ms,
        "event_ms": k6a_ev,
        "wrapper_ms": k6a_call_ms - k6a_ev,
        "plain_ms": k6a_plain_ms,
    }, *forward_work(cfg.n_rays, cfg.max_depth, int(k_seg.sum()),
                     scene.spheres.c0.shape[0], 0, defer=True))
    k8 = bound({
        "name": "perlin_turbulence",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/perlin_turb.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/perlin_turb.py:37",
        "launches": k8_launches,
        "max_abs_err": k8_err,
        "ms": k8_ms,
        "event_ms": k8_ev,
        "wrapper_ms": k8_call_ms - k8_ev,
        "plain_ms": k8_plain_ms,
    }, *k8_work)
    return k6a, k8, frames


def deferred_training(dev, smi, frames):
    """Phase 10: K9 against its plain version on two_perlin_spheres' records
    (real live mask), K7 against its plain version on each scene's own codes
    with the combine's real cotangents, the forward+backward frame of each
    scene through render_fused_diff and InverseRenderer.fit on earth (the
    image atlas), with the launch counts reset just before. Returns the
    kernels line's K7 and K9 entries."""
    import torch

    from raytracer_weekend_tpu_torch import fused_diff, integrator, textures
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    # ---- 10a. K9 against its plain version ----------------------------------
    scene, static, cfg, cam = frames["two_perlin_spheres"][:4]
    grad, perm = scene.textures.perlin_grad, scene.textures.perlin_perm
    _, _, _, abc, dcode = mk.render_fused_records(
        scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static)
    pts, live = noise_points(scene, dcode, abc)
    gen = torch.Generator(device=dev).manual_seed(10)
    ct = torch.randn(pts.shape[0], device=dev, generator=gen)
    dg, dp = pt.turbulence_vjp(grad, perm, pts, ct, 7, live)
    rg, rp = turb_vjp_plain(grad, perm, pts, ct, live)
    torch.cuda.synchronize()
    k9_stats = dict(points=pts.shape[0], live=int(live.sum()),
                    dead_dp_zero=bool((dp[~live] == 0).all()),
                    d_grad_norm_rel=float((dg - rg).norm() / rg.norm()),
                    d_p_norm_rel=float((dp - rp).norm() / rp.norm()))
    print(f"phase 10 K9 vs plain, two_perlin_spheres' records "
          f"({k9_stats['live'] / k9_stats['points']:.4f} of them live): "
          f"{json.dumps(k9_stats)} (budget {TURB_NORM_REL})", flush=True)
    if not (k9_stats["dead_dp_zero"]
            and k9_stats["d_grad_norm_rel"] <= TURB_NORM_REL
            and k9_stats["d_p_norm_rel"] <= TURB_NORM_REL):
        raise AssertionError(f"K9 vs plain: {k9_stats}")
    k9_err = float(max((dg - rg).abs().max(), (dp - rp).abs().max()))
    k9_ops = pt.vjp_operands(grad, perm, pts, ct, live)
    k9_ms, k9_ev = launch_times(lambda: pt._launch_vjp(k9_ops))
    k9_call_ms = cuda_ms(
        lambda: pt.turbulence_vjp(grad, perm, pts, ct, 7, live), 5)
    k9_plain_ms = cuda_ms(lambda: turb_vjp_plain(grad, perm, pts, ct, live),
                           1)
    print(f"phase 10 timing K9 on two_perlin_spheres' records: the launch "
          f"alone {k9_ms:.3f} ms ({k9_ev:.3f} by events), turbulence_vjp "
          f"{k9_call_ms:.3f} ms, plain "
          f"{k9_plain_ms:.3f} ms (median; {smi})", flush=True)
    # Bytes: a live point reads p and ct; every point reads its mask byte and
    # writes d_p; the tables are read and d_grad (3 KB) written once.
    k9_work = (k9_stats["live"] * 7 * OPS_TURB_VJP_OCTAVE,
               k9_stats["live"] * 16 + pts.shape[0] * 13 + 6144 + 3072)

    # The combine reads a texture table of at most _SELECT_ROWS rows by one
    # select per row (textures._rows), not by index_select, whose backward
    # adds every record into the same few rows: both, forward+backward, on
    # the records' texture ids and on random ids over _SELECT_ROWS rows.
    tid = (dcode.abs() - 1).clamp_min(0).long().reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(12)
    rows_ms = {}
    for k_rows, ids in ((scene.textures.color1.shape[0], tid),
                        (textures._SELECT_ROWS, torch.randint(
                            0, textures._SELECT_ROWS, tid.shape, device=dev,
                            generator=gen))):
        tab = torch.rand((k_rows, 3), device=dev, generator=gen,
                         requires_grad=True)
        ct_rows = torch.rand((ids.shape[0], 3), device=dev, generator=gen)
        for how, read in (("select", textures._rows),
                          ("index_select",
                           lambda tb, ix: torch.index_select(tb, 0, ix))):
            def rows_fb():
                return torch.autograd.grad(read(tab, ids), tab, ct_rows)
            rows_fb()
            rows_ms[f"{how}, {k_rows} rows"] = cuda_ms(rows_fb, 5)
    print(f"phase 10 texture-row reads, forward+backward over "
          f"{tid.shape[0]} records (ms, median of 5; {smi}): "
          f"{json.dumps(rows_ms)}", flush=True)

    # ---- 10b. K7 against its plain version and the float64 witness -------------
    k7_err, k7_work = 0.0, None
    k7_ms = k7_ev = k7_call_ms = k7_plain_ms = None
    for name in DEFERRED:
        scene, static, cfg, cam, k_rad, k_seg = frames[name]
        n, seed = cfg.n_rays, cfg.seed
        rad, _, codes, *recs = mk.render_fused(
            scene, cfg, cam, 0, n, seed, static=static, emit_paths=True,
            emit_deferred=True)
        g_k, cabc, _ = fused_diff.combine_vjp(scene, static, recs, 2.0 * rad,
                                              [])
        o, d, t, rid = integrator._pixel_rays(
            cam, cfg, torch.arange(n, dtype=torch.int64, device=dev), seed)
        ktab = rb.pack_ktab(scene).detach()
        ptab = (rb.pack_ptab(scene, static).detach()
                if static.n_rects + static.n_triangles else None)
        wins = lane_windows(n, PLAIN_CHUNK)
        # Random cotangents: g on every record, cabc on the noise records
        # (the only ones whose hit point the combine reads).
        gen = torch.Generator(device=dev).manual_seed(11)
        g_r = torch.randn(g_k.shape, device=dev, generator=gen)
        c_r = None if cabc is None else torch.randn(
            g_k.shape, device=dev, generator=gen) * \
            noise_points(scene, recs[2], recs[1])[1].view(n, -1, 1)
        flips = (codes != float64_codes(scene, static, cfg, o, d, t, rid,
                                        wins)).any(dim=1)

        def k7(g, c):
            return rb.replay_bwd_fused(ktab, ptab, scene.background, cfg, o,
                                       d, t, rid, seed, codes, g, n, cabc=c)

        def k7_plain(g, c, dtype=None, rays=(o, d)):
            return plain_backward(ktab, ptab, scene.background, cfg, *rays, t,
                                  rid, seed, codes, g, wins, cabc=c,
                                  dtype=dtype)

        # The same rays moved by one float32 ulp, each component up or down.
        gen_j = torch.Generator(device=dev).manual_seed(13)
        jittered = tuple(
            x.double() * (1.0 + 2.0 ** -23 * (2 * torch.randint(
                0, 2, x.shape, device=dev, generator=gen_j) - 1))
            for x in (o, d))

        for kind, g, c in (("real", g_k, cabc), ("random", g_r, c_r)):
            got, ref = k7(g, c), k7_plain(g, c)
            wit = k7_plain(g, c, torch.float64)
            ill = (ill_lanes(ref, wit)
                   | ill_lanes(k7_plain(g, c, torch.float64, jittered), wit))
            torch.cuda.synchronize()
            held = ill | flips
            keep = (~held).to(g.dtype).view(n, 1, 1)
            g_h, c_h = g * keep, None if c is None else c * keep
            witness = {f"{nm} K7/plain32 vs float64": [norm_rel(a, w),
                                                        norm_rel(b, w)]
                       for nm, a, b, w in zip(OUTPUTS, got, ref, wit)
                       if w is not None and bool((w != 0).any())}
            got, ref = k7(g_h, c_h), k7_plain(g_h, c_h)
            wit = k7_plain(g_h, c_h, torch.float64)
            torch.cuda.synchronize()
            # float32's resolution of each output on the held lanes: the
            # plain version's distance from the witness.
            res = {nm: norm_rel(b, w) for nm, b, w in zip(OUTPUTS, ref, wit)
                   if w is not None and bool((w != 0).any())}
            plain = agree_all(got, ref, check=False)
            f64 = agree_all(got, wit, check=False)
            stats = dict(held_out=dict(ill_conditioned=int(ill.sum()),
                                       path_flips=int(flips.sum()),
                                       total=int(held.sum()),
                                       budget=max(4, n // HELD_OUT)),
                         all_lanes=witness, float32_resolution=res,
                         plain=brief(plain), float64=brief(f64))
            print(f"phase 10 K7 vs plain {name} {cfg.width}x{cfg.height} "
                  f"spp {cfg.samples_per_pixel} depth {cfg.max_depth}, "
                  f"{kind} cotangents"
                  f"{' (g = the combine VJP of 2 rad)' if kind == 'real' else ''}"
                  f": {json.dumps(stats)}", flush=True)
            if int(held.sum()) > max(4, n // HELD_OUT):
                raise AssertionError(f"K7: {int(held.sum())} lanes held out")
            if not all(s_["ok"] for s_ in plain + f64):
                raise AssertionError(f"K7 vs plain outside budgets: {stats}")
            k7_err = max(k7_err, max(s_["max_abs_err"] for s_ in plain))
        if name == "two_perlin_spheres":
            k7_ops = rb.operands(ktab, ptab, scene.background, cfg, o, d, t,
                                 rid, seed, codes, g_k, n, cabc=cabc)
            k7_ms, k7_ev = launch_times(lambda: rb._launch(k7_ops))
            k7_call_ms = cuda_ms(lambda: k7(g_k, cabc), 5)
            k7_plain_ms = cuda_ms(lambda: k7_plain(g_k, cabc), 1)
            k7_work = backward_work(n, cfg.max_depth, int(k_seg.sum()),
                                    ktab.shape[1], 0, defer=True, noise=True)
            print(f"phase 10 timing two_perlin_spheres: K7's launch alone "
                  f"{k7_ms:.3f} ms ({k7_ev:.3f} by events), "
                  f"replay_bwd_fused {k7_call_ms:.3f} ms, "
                  f"plain {k7_plain_ms:.3f} ms (median; {smi})", flush=True)

    # ---- 10c. forward+backward frames -----------------------------------------
    k7_launches = k9_launches = 0
    for name in DEFERRED:
        scene, static, cfg, cam, _, k_seg = frames[name]
        mk.DEFER_LAUNCHES = pt.TURB_LAUNCHES = 0
        rb.DEFER_LAUNCHES = pt.TURB_VJP_LAUNCHES = 0
        fb_ms, grads = fwd_bwd_ms(scene, static, cfg, cam)
        counts = dict(K6a=mk.DEFER_LAUNCHES, K8=pt.TURB_LAUNCHES,
                      K7=rb.DEFER_LAUNCHES, K9=pt.TURB_VJP_LAUNCHES)
        noise = static.has_noise and not static.defer_single_hit
        if (min(counts["K6a"], counts["K7"]) < 1
                or (noise and min(counts["K8"], counts["K9"]) < 1)):
            raise AssertionError(f"{name} forward+backward launches {counts}")
        k7_launches += counts["K7"]
        k9_launches += counts["K9"]
        segs = int(k_seg.sum())
        print(f"phase 10 forward+backward {name} {cfg.width}x{cfg.height} "
              f"spp {cfg.samples_per_pixel} depth {cfg.max_depth} on {smi}: "
              f"launches {json.dumps(counts)}, frame {fb_ms:.3f} ms, "
              f"{segs / (fb_ms / 1e3):.4e} segments/s; every gradient finite",
              flush=True)

    # ---- 10d. InverseRenderer.fit on earth: the image atlas -------------------
    scene, static, cfg, cam, _, _ = frames["earth"]
    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    start = scene._replace(textures=scene.textures._replace(
        images=scene.textures.images * 0.8))
    images = start.textures.images.clone().requires_grad_()
    ir = InverseRenderer(static, cfg, cam, target)
    loss = ir.loss(start._replace(textures=start.textures._replace(
        images=images)))
    (g_img,) = torch.autograd.grad(loss, images)
    texels = int((g_img.abs().sum(-1) > 0).sum())
    mk.DEFER_LAUNCHES = rb.DEFER_LAUNCHES = 0
    hist, step_ms = fit_three_steps(static, cfg, cam, target, start)
    fit_counts = (mk.DEFER_LAUNCHES, rb.DEFER_LAUNCHES)
    if min(fit_counts) < 1 or texels == 0:
        raise AssertionError(f"earth fit: K6a/K7 launches {fit_counts}, "
                             f"{texels} texels with a gradient")
    k7_launches += fit_counts[1]
    print(f"phase 10 training path: InverseRenderer.fit earth {cfg.width}x"
          f"{cfg.height} spp {cfg.samples_per_pixel} depth {cfg.max_depth}, "
          f"3 Adam steps from the atlas x 0.8 on {smi}: {fit_counts[0]} K6a "
          f"and {fit_counts[1]} K7 launches; {texels} texels with a nonzero "
          f"gradient (max {float(g_img.abs().max()):.3e}); loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f})", flush=True)
    k7 = bound({
        "name": "replay_bwd_deferred",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/replay_bwd.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/replay_bwd.py:191",
        "launches": k7_launches,
        "max_abs_err": k7_err,
        "ms": k7_ms,
        "event_ms": k7_ev,
        "wrapper_ms": k7_call_ms - k7_ev,
        "plain_ms": k7_plain_ms,
    }, *k7_work)
    k9 = bound({
        "name": "perlin_turbulence_vjp",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/perlin_turb.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/perlin_turb.py:228",
        "launches": k9_launches,
        "max_abs_err": k9_err,
        "ms": k9_ms,
        "event_ms": k9_ev,
        "wrapper_ms": k9_call_ms - k9_ev,
        "plain_ms": k9_plain_ms,
    }, *k9_work)
    return k7, k9


# ---- constant-density media and the depth-phased render (phases 11-13) ------

BOOK2_REDUCED = dict(width=160, height=90, samples_per_pixel=4, max_depth=8)
# bench.py --config book2_criterion (bench.py:88-93): book2 built from seed
# 1337, 40x22, 100 spp, depth 50, render seed 1337, one chunk.
CRITERION = dict(width=40, height=22, samples_per_pixel=100, max_depth=50,
                 seed=1337, ray_batch=1 << 17)
# The benchmark's rtw2_final.pass10 frame (400x225, 10 spp a pass, depth
# 50) on the criterion's book2: its first phase's 900,000 live lanes fill
# the card at one lane a ray.
BOOK2_PASS10 = dict(width=400, height=225, samples_per_pixel=10,
                    max_depth=50, seed=1337)
# book2's plain version holds (B, 1006) and (B, 2401) planes per bounce:
# ~14 KB a lane for each plane.
BOOK2_CHUNK = 1 << 12
BOOK2_TIMING_CHUNK = 1 << 14
# book2's forward+backward (torch autograd of the replay, its turbulence
# evaluated for every lane and bounce) at full width with 4 spp: the
# replay's autograd at 16 spp would hold ~25 GB of turbulence intermediates.
BOOK2_DIFF = dict(width=400, height=225, samples_per_pixel=4, max_depth=8)


def volume_forward(dev, smi, log):
    """Phase 11: K5 against its plain version with the budgets of
    tests/test_megakernel.py:214-258 on smokey_cornell_box (full size, plain
    in 2^17-lane windows) and sphere_medium (64x36, 4 spp, depth 6), and
    of :359-381 on book2 at 160x90, 4 spp, depth 8 (its plain version in
    2^12-lane windows: at full size it alone would take minutes); the media
    kernel as compiled (block, registers of its instantiations: raises on a
    spill) and each scene's resident blocks; then the forward main path,
    render_image of smokey_cornell_box and book2 at full size with the
    launch counts reset just before each. Returns the kernels line's K5
    entry, K3's book2 entry and smokey's (scene, static, cfg, cam, rad,
    seg)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    failed, frames = [], {}
    for name, size, window, budgets in (
            ("smokey_cornell_box", FULL, PLAIN_CHUNK, VOLUME_BUDGETS),
            ("sphere_medium", SMALL, PLAIN_CHUNK, VOLUME_BUDGETS),
            ("book2_final_scene", BOOK2_REDUCED, BOOK2_CHUNK,
             BOOK2_REDUCED_BUDGETS)):
        scene, static, cfg, cam = load_scene(name, size, dev)
        k_rad, k_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static)
        p_rad, p_seg = plain_forward(scene, static, cfg, cam, window)
        torch.cuda.synchronize()
        ok, stats = _budgets(k_rad, p_rad, k_seg.sum(), p_seg.sum(),
                             cfg.n_rays, **budgets)
        stats.update(kernel_segments=int(k_seg.sum()),
                     plain_segments=int(p_seg.sum()))
        print(f"phase 11 K5 vs plain {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel} depth {cfg.max_depth} (plain in "
              f"{window}-lane windows): {json.dumps(stats)}", flush=True)
        if not ok:
            failed.append((name, stats))
        frames[name] = (scene, static, cfg, cam, k_rad, k_seg, window, stats)
    if failed:
        raise AssertionError(f"K5 vs plain outside budgets: {failed}")
    media_design(log, dev, frames)

    scene, static, cfg, cam, k_rad, k_seg, window, sstats = \
        frames["smokey_cornell_box"]
    k5_call_ms = cuda_ms(lambda: mk.render_fused(
        scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static), 5)
    k5_ms, k5_ev = launch_ms(scene, static, cfg, cam)
    plain_ms = cuda_ms(lambda: plain_forward(scene, static, cfg, cam,
                                              window), 3)
    print(f"phase 11 K5 timing smokey_cornell_box: render_fused frame "
          f"{k5_call_ms:.3f} ms, the launch alone {k5_ms:.3f} ms on the "
          f"device ({k5_ev:.3f} by events), plain "
          f"version frame {plain_ms:.3f} ms (median; {smi})", flush=True)
    smokey = (scene, static, cfg, cam, k_rad, k_seg)

    launches = 0
    for name in ("smokey_cornell_box", "book2_final_scene"):
        if name == "smokey_cornell_box":
            scene, static, cfg, cam, k_rad, k_seg = smokey
        else:
            scene, static, cfg, cam = load_scene(name, FULL, dev)
            k_rad, k_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                           cfg.seed, static=static)
        mk.VOL_LAUNCHES = mk.PLANAR_LAUNCHES = 0
        frame_ms, png = time_render_image(name, scene, static, cfg, cam,
                                          k_rad)
        count, k3_count = mk.VOL_LAUNCHES, mk.PLANAR_LAUNCHES
        if count < 1 or k3_count < 1:
            raise AssertionError(f"render_image({name}) launched K5 {count},"
                                 f" K3 {k3_count} times")
        launches += count
        med = statistics.median(frame_ms)
        segs = int(k_seg.sum())
        print(f"phase 11 main path: render_image {name} {cfg.width}x"
              f"{cfg.height} spp {cfg.samples_per_pixel} depth "
              f"{cfg.max_depth} on {smi}: {count} K5 launches, median frame "
              f"{med:.3f} ms (min {min(frame_ms):.3f}, max "
              f"{max(frame_ms):.3f}), {segs} segments/frame, "
              f"{segs / (med / 1e3):.4e} segments/s; image -> {png}",
              flush=True)
        if name == "book2_final_scene":  # K3's book2 row: its planar loop
            k3_book2 = k3_entry(name, scene, static, cfg, cam, k_seg,
                                k3_count, frames[name][-1]["max_abs_err"],
                                None, smi)
    s_scene, s_static, s_cfg = smokey[:3]
    return bound({
        "name": "megakernel_volume_forward",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
        "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
        "launches": launches,
        "max_abs_err": sstats["max_abs_err"],
        "ms": k5_ms,
        "event_ms": k5_ev,
        "wrapper_ms": k5_call_ms - k5_ev,
        "plain_ms": plain_ms,
    }, *forward_work(s_cfg.n_rays, s_cfg.max_depth,
                     sstats["kernel_segments"], 0,
                     s_static.n_rects + s_static.n_triangles,
                     V=s_static.n_volumes)), k3_book2, smokey


def media_design(log, dev, frames):
    """The media kernel as compiled (see volume_forward)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    regs = [r for r in ptxas_registers(log) if r.startswith("media_kernel")]
    if len(regs) != 6 or any("spills" in r for r in regs):
        raise AssertionError(f"media_kernel instantiations: {regs}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"phase 11 the media kernel as compiled: block {mk.MEDIA_BLOCK}, "
          f"one lane slot a thread, tables from global memory; registers "
          f"(ptxas, <emit,defer,phase>): {' | '.join(regs)}", flush=True)
    for name, (scene, static, cfg, *_rest) in frames.items():
        print(f"phase 11 {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel} depth {cfg.max_depth} "
              f"({static.n_spheres} spheres, "
              f"{static.n_rects + static.n_triangles} planar rows, "
              f"{static.n_volumes} media): "
              f"{mk.resident_blocks(static, dev, phase=False)} resident "
              f"blocks an SM on {sms} SMs", flush=True)


def deep_phases(dev, smi):
    """Phase 12: the depth-phased render (K6b) on bench.py's
    book2_criterion, on book2 at the benchmark's rtw2_final.pass10 frame
    (400x225, 10 spp, depth 50: BOOK2_PASS10) and on jumpy_balls at depth
    20 (400x225, 4 spp): each bitwise the single-pass launch with the lanes
    per ray forced to each G of mk.GROUPS and with G chosen from each
    phase's live lanes, and book2 at G = 1 also with its launches kept on
    render_kernel (`refill=False`; G = 1 with media is media_kernel's);
    deep against single-pass frame ms in turns (book2 also deep on
    render_kernel alone); the criterion's main path (`deep_main_path`);
    then each of the criterion's phases launched again from its own inputs,
    timed, and held against its plain version from the same state (book2
    budgets); last, the pass10 frame's main path, and the first phase at
    G = 1 of the criterion and of the pass10 frame on media_kernel and on
    render_kernel from the same inputs (all outputs bitwise), each timed
    and held against its plain version. Returns the kernels line's K6b
    entries, one a phase and two a refill comparison."""
    import torch

    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    cfg = RenderConfig(**CRITERION)
    objs, cams, bg = scenes.book2_final_scene(cfg.aspect_ratio, seed=1337)
    scene, static = build_scene(objs, background=bg, seed=cfg.seed)
    scene, cam = scene.to(dev), cams[0].to(dev)
    jc = RenderConfig(width=400, height=225, samples_per_pixel=4,
                      max_depth=20)
    jscene, jstatic, jcams = scenes.generate_scene("jumpy_balls",
                                                   jc.aspect_ratio,
                                                   device=dev)
    pc = RenderConfig(**BOOK2_PASS10)
    runs = {"book2_criterion": (scene, static, cfg, cam),
            "book2_pass10": (scene, static, pc, cam),
            "jumpy_balls_d20": (jscene, jstatic, jc, jcams[0].to(dev))}

    timings, phase_log, g1_log, singles = {}, {}, {}, {}
    for name, (sc, st, cf, cm) in runs.items():
        def single():
            return mk.render_fused(sc, cf, cm, 0, cf.n_rays, cf.seed,
                                   static=st, deep=False)

        def deep(group=None, live=None, phases=None, refill=True):
            return mk._render_deep(sc, cf, cm, 0, cf.n_rays, cf.seed,
                                   static=st, group=group, live_counts=live,
                                   phases=phases, refill=refill)

        def deep_rk():
            return deep(refill=False)

        s_out = single()
        singles[name] = s_out
        live, phases, g1 = [], [], []
        outs = {g: deep(g, phases=g1 if g == 1 else None)
                for g in mk.GROUPS}
        outs["auto"] = deep(None, live, phases)
        if st.n_volumes:
            outs["1 on render_kernel"] = deep(1, refill=False)
            outs["auto on render_kernel"] = deep_rk()
        torch.cuda.synchronize()
        equal = {str(g): all(torch.equal(a, b) for a, b in zip(o, s_out))
                 for g, o in outs.items()}
        if not all(equal.values()):
            raise AssertionError(f"{name}: the phased render is not the "
                                 f"single pass bit for bit: {equal}")
        fns = {"single": single, "deep": deep}
        order = ["single", "deep", "deep", "single"]
        if st.n_volumes:
            fns["deep_render_kernel"] = deep_rk
            order = ["single", "deep", "deep_render_kernel",
                     "deep_render_kernel", "deep", "single"]
        times = {k: [] for k in fns}
        for who in order:
            times[who].append(cuda_ms(fns[who], 5))
        timings[name] = {k: statistics.median(v) for k, v in times.items()}
        phase_log[name] = phases
        g1_log[name] = g1
        print(f"phase 12 {name} {cf.width}x{cf.height} spp "
              f"{cf.samples_per_pixel} depth {cf.max_depth}: the phased "
              f"render bitwise the single pass with G forced to each of "
              f"{list(mk.GROUPS)} and with G from the live lanes "
              f"({json.dumps(equal)}); live lanes after each phase {live} "
              f"of {cf.n_rays}; G per phase "
              f"{[ph['group'] for ph in phases]} on "
              f"{[ph['kernel'] for ph in phases]} (from "
              f"{mk.resident_blocks(st, dev)} resident blocks an SM); "
              f"render_fused_deep "
              f"{timings[name]['deep']:.3f} ms, single pass "
              f"{timings[name]['single']:.3f} ms (CUDA events, medians of 5"
              f" in turns {'/'.join(order)}: {json.dumps(times)}; "
              f"{smi})", flush=True)

    # The criterion's main path, counted from 0.
    phases = phase_log["book2_criterion"]
    main = {"book2_criterion": deep_main_path("book2_criterion", *runs[
        "book2_criterion"], singles["book2_criterion"], phases, smi)}
    k6b_launches = main["book2_criterion"][0]

    # Each phase again from its own inputs: timed, and held against its
    # plain version from the same state.
    entries, ms_sum = [], 0.0
    tables = mk.build_tables(scene, static, cam)
    for k, ph in enumerate(phases):
        cf, nl, d0, g = ph["cfg"], ph["lanes"], ph["d0"], ph["group"]
        st_in, ids = ph["state"], ph["ids"]

        def launch():
            return mk._launch(scene, cf, cam, 0, nl, cfg.seed, static,
                              phase=True, state=st_in, lanes=ids, d0=d0,
                              tables=tables, group=g)

        k_out = launch()
        ms, ev = launch_times(launch)
        ms_sum += ev
        ids_all = (torch.arange(nl, dtype=torch.int32, device=dev)
                   if ids is None else ids)
        plain_out = []

        def plain():
            outs = [mk.phase_reference(
                scene, cf, cam, ids_all[w],
                None if st_in is None else st_in[w], d0, cfg.seed,
                static=static) for w in lane_windows(nl, BOOK2_CHUNK)]
            plain_out[:] = [torch.cat([o[i] for o in outs])
                            for i in range(len(outs[0]))]

        plain_ms = cuda_ms(plain, 1)
        p_out = plain_out
        ok, stats = _budgets(k_out[-1][:, 9:12], p_out[-1][:, 9:12],
                             k_out[1].sum(), p_out[1].sum(), nl,
                             **BOOK2_BUDGETS)
        seg0 = 0 if st_in is None else int(st_in[:, 14].double().sum())
        phase_segs = int(k_out[1].sum()) - seg0
        stats.update(alive_equal=int((k_out[-1][:, 13]
                                      == p_out[-1][:, 13]).sum()),
                     phase_segments=phase_segs)
        print(f"phase 12 K6b phase {k + 1} of book2_criterion (bounces "
              f"{d0}-{d0 + cf.max_depth - 1}, {nl} lanes, G {g}, "
              f"{ph['kernel']}): "
              f"{ms:.3f} ms a launch ({ev:.3f} by events), plain "
              f"{plain_ms:.3f} ms; kernel vs "
              f"plain from the same state, radiance and segments in the "
              f"state: {json.dumps(stats)} ({smi})", flush=True)
        if not ok:
            raise AssertionError(f"K6b phase {k + 1} vs plain outside "
                                 f"budgets: {stats}")
        # A phase writes its lanes' rad, seg, records and state, and a
        # resumed one reads their state and ids as well.
        entries.append(bound({
            "name": f"megakernel_phase_io[book2_criterion phase {k + 1}]",
            "route": "cuda",
            "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
            "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
            "launches": k6b_launches // len(phases),
            "max_abs_err": stats["max_abs_err"],
            "ms": ms,
            "event_ms": ev,
            "plain_ms": plain_ms,
        }, *forward_work(nl, cf.max_depth, phase_segs, static.n_spheres,
                         static.n_rects + static.n_triangles, defer=True,
                         V=static.n_volumes,
                         phase_lanes=nl if st_in is None else 2 * nl)))
    deep_ms = timings['book2_criterion']['deep']
    print(f"phase 12 timing: the criterion's phases {ms_sum:.3f} ms in all "
          f"launched alone (by events), against the whole render_fused_deep "
          f"{deep_ms:.3f} ms (the host's live count, gathers and combine "
          f"between them) ({smi})", flush=True)
    # The phases' wrapper: render_fused_deep's work around its launches,
    # an equal share a phase.
    for e in entries:
        e["wrapper_ms"] = (deep_ms - ms_sum) / len(entries)
    # The refill comparison. A row's launches are its main path's: those
    # of the G = 1 first phase on that kernel (render_image, counted from
    # 0); its wrapper_ms, where it has launches, render_fused_deep's share
    # a phase as above, else null.
    main["book2_pass10"] = deep_main_path(
        "book2_pass10", *runs["book2_pass10"], singles["book2_pass10"],
        phase_log["book2_pass10"], smi)
    for name in ("book2_criterion", "book2_pass10"):
        sc, st, cf, cm = runs[name]
        plan, (n_phase, n_refill) = phase_log[name], main[name]
        frames, first = n_phase // len(plan), plan[0]
        launches = {k: (frames if first["group"] == 1
                        and first["kernel"] == k else 0)
                    for k in ("media_kernel", "render_kernel")}
        planned = frames * sum(ph["kernel"] == "media_kernel"
                               for ph in plan)
        if n_refill != planned:
            raise AssertionError(f"{name}: {n_refill} launches on "
                                 f"media_kernel on the main path, for "
                                 f"{planned} in its phase plan")
        wrapper = {k: None for k in launches}
        if any(launches.values()):
            ev_sum = phases_event_ms(sc, st, cf, cm, plan)
            wrapper[first["kernel"]] = ((timings[name]["deep"] - ev_sum)
                                        / len(plan))
        entries += refill_rows(name, sc, st, cf, cm, g1_log[name][0],
                               launches, wrapper, smi)
    return entries


def deep_main_path(name, scene, static, cfg, cam, single, plan, smi):
    """A deep frame's main path, the launch counts set to 0 just before:
    render_image when render_fused's default takes the phases, else
    render_fused_deep (1 warm-up and 10 frames), each frame bitwise the
    single pass `single` (its radiance and segments), in whole frames of
    the phase plan `plan` -> (K6b launches, of these on media_kernel)."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    s_rad, s_seg = single[:2]
    mk.PHASE_LAUNCHES = mk.REFILL_LAUNCHES = 0
    frame_ms, png = time_render_image(name, scene, static, cfg, cam, s_rad)
    route = "render_image"
    if mk.PHASE_LAUNCHES == 0:  # the default is the single pass
        route = "render_fused_deep"
        for _ in range(11):
            rad, _ = mk.render_fused_deep(scene, cfg, cam, 0, cfg.n_rays,
                                          cfg.seed, static=static)
        torch.cuda.synchronize()
        if not torch.equal(rad, s_rad):
            raise AssertionError("render_fused_deep != the single pass")
    k6b, refills = mk.PHASE_LAUNCHES, mk.REFILL_LAUNCHES
    if k6b < 1 or k6b % len(plan):
        raise AssertionError(f"{name}: {k6b} K6b launches through {route} "
                             f"for {len(plan)} phases")
    print(f"phase 12 main path: {name} through {route} (render_image's "
          f"route: {'deep' if route == 'render_image' else 'single'} pass) "
          f"on {smi}: {k6b} K6b launches, {refills} of them on media_kernel;"
          f" render_image median frame {statistics.median(frame_ms):.3f} ms,"
          f" {int(s_seg.sum())} segments/frame; image -> {png}", flush=True)
    return k6b, refills


def phases_event_ms(scene, static, cfg, cam, plan):
    """The phases of `plan` (a phased render's `phases` log), each launched
    alone from its inputs on its own kernel: their CUDA-event ms summed
    (medians of 5)."""
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    tables = mk.build_tables(scene, static, cam)
    return sum(cuda_ms(lambda ph=ph: mk._launch(
        scene, ph["cfg"], cam, 0, ph["lanes"], cfg.seed, static, phase=True,
        state=ph["state"], lanes=ph["ids"], d0=ph["d0"], tables=tables,
        group=ph["group"], kernel=ph["kernel"]), 5) for ph in plan)


def refill_rows(name, scene, static, cfg, cam, ph, launches, wrapper, smi):
    """Phase 12's refill comparison: the phase `ph` (from a phased render
    at G = 1) launched again from its inputs on media_kernel (the refill)
    and on render_kernel: every output bitwise, each launch timed alone,
    and the radiance and segments in the state held against the plain
    version from the same state (book2 budgets). `launches` and `wrapper`
    give each kernel's main-path launches and wrapper ms. Returns the two
    kernels-line entries."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    cf, nl, d0, st_in, ids = (ph["cfg"], ph["lanes"], ph["d0"], ph["state"],
                              ph["ids"])
    tables = mk.build_tables(scene, static, cam)

    def launch(refill):
        return mk._launch(scene, cf, cam, 0, nl, cfg.seed, static,
                          phase=True, state=st_in, lanes=ids, d0=d0,
                          tables=tables, group=1,
                          kernel="media_kernel" if refill
                          else "render_kernel")

    outs = {r: launch(r) for r in (True, False)}
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(outs[True], outs[False])]
    if not all(same):
        raise AssertionError(f"{name} phase at d0 {d0}: media_kernel and "
                             f"render_kernel differ: {same}")
    ids_all = (torch.arange(nl, dtype=torch.int32, device=scene.device)
               if ids is None else ids)
    plain_out = []

    def plain():
        parts = [mk.phase_reference(
            scene, cf, cam, ids_all[w], None if st_in is None else st_in[w],
            d0, cfg.seed, static=static) for w in lane_windows(nl,
                                                               BOOK2_CHUNK)]
        plain_out[:] = [torch.cat([o[i] for o in parts])
                        for i in range(len(parts[0]))]

    plain_ms = cuda_ms(plain, 1)
    k_out, p_out = outs[True], plain_out
    ok, stats = _budgets(k_out[-1][:, 9:12], p_out[-1][:, 9:12],
                         k_out[1].sum(), p_out[1].sum(), nl, **BOOK2_BUDGETS)
    if not ok:
        raise AssertionError(f"{name} refill phase vs plain outside "
                             f"budgets: {stats}")
    seg0 = 0 if st_in is None else int(st_in[:, 14].double().sum())
    phase_segs = int(k_out[1].sum()) - seg0
    times = {True: [], False: []}
    for r in (True, False, False, True):
        times[r].append(launch_times(lambda: launch(r)))
    rows = []
    for r, kernel in ((True, "media_kernel"), (False, "render_kernel")):
        ms = statistics.median(t[0] for t in times[r])
        ev = statistics.median(t[1] for t in times[r])
        print(f"phase 12 K6b refill {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel}: phase at bounces {d0}-"
              f"{d0 + cf.max_depth - 1}, {nl} lanes, G 1 on {kernel}: "
              f"{ms:.3f} ms a launch ({ev:.3f} by events; in turns "
              f"refill/render_kernel/render_kernel/refill: "
              f"{json.dumps([list(t) for t in times[r]])}), "
              f"{phase_segs} segments; all outputs bitwise the other "
              f"kernel's; {launches[kernel]} launches on the main path, "
              f"wrapper {wrapper[kernel]} ms; plain {plain_ms:.3f} ms, "
              f"kernel vs plain from the same state: {json.dumps(stats)} "
              f"({smi})", flush=True)
        rows.append(bound({
            "name": f"megakernel_phase_io[{name} phase {d0 // mk.PHASE_LEN + 1}"
                    f" G 1 {kernel}]",
            "route": "cuda",
            "source": "raytracer_weekend_tpu_torch/csrc/megakernel.cuh",
            "replaces": "raytracer_weekend_tpu/ops/pallas/megakernel.py:227",
            "launches": launches[kernel],
            "max_abs_err": stats["max_abs_err"],
            "ms": ms,
            "event_ms": ev,
            "wrapper_ms": wrapper[kernel],
            "plain_ms": plain_ms,
        }, *forward_work(nl, cf.max_depth, phase_segs, static.n_spheres,
                         static.n_rects + static.n_triangles, defer=True,
                         V=static.n_volumes,
                         phase_lanes=nl if st_in is None else 2 * nl)))
    return rows


def volume_training(dev, smi, smokey):
    """Phase 13: K5-emit on smokey_cornell_box at full size (bitwise K5's
    radiance and segments, codes against the plain version's), one
    forward+backward frame through render_fused_diff (K5-emit, then torch
    autograd of the replay), InverseRenderer.fit for 3 Adam steps from the
    media's albedo + 0.2 with the counts reset just before, and book2's
    forward+backward frame at BOOK2_DIFF."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    scene, static, cfg, cam, k_rad, k_seg = smokey
    n, seed = cfg.n_rays, cfg.seed
    e_rad, e_seg, codes = mk.render_fused(scene, cfg, cam, 0, n, seed,
                                          static=static, emit_paths=True)
    p_rad, p_seg, p_codes = plain_forward(scene, static, cfg, cam,
                                          PLAIN_CHUNK, emit=True)
    torch.cuda.synchronize()
    if not (torch.equal(e_rad, k_rad) and torch.equal(e_seg, k_seg)):
        raise AssertionError("K5-emit changed smokey's radiance/segments")
    nz = (codes > 0).sum(1)
    if not bool(((nz == e_seg) | (nz == e_seg - 1)).all()):
        raise AssertionError("K5-emit codes: nonzero count not seg or seg-1")
    code_lanes = int((codes != p_codes).any(1).sum())
    media_codes = int(((codes & 3) == 3).sum())
    if code_lanes > n // 100 or media_codes == 0:
        raise AssertionError(f"K5-emit codes differ from the plain version's"
                             f" on {code_lanes} lanes (budget {n // 100}), "
                             f"{media_codes} medium codes")
    print(f"phase 13 K5-emit smokey_cornell_box: radiance and segments "
          f"bitwise K5's; codes differ from the plain version's on "
          f"{code_lanes} of {n} lanes (budget {n // 100}); {media_codes} "
          f"medium scatters", flush=True)

    before = mk.VOL_LAUNCHES, mk.EMIT_LAUNCHES, rb.LAUNCHES
    fb_ms, grads = fwd_bwd_ms(scene, static, cfg, cam)
    counts = (mk.VOL_LAUNCHES - before[0], mk.EMIT_LAUNCHES - before[1],
              rb.LAUNCHES - before[2])
    if min(counts[:2]) < 1 or counts[2] != 0:
        raise AssertionError(f"smokey forward+backward: K5/K5-emit/K2 "
                             f"launches {counts}")
    segs = int(k_seg.sum())
    print(f"phase 13 forward+backward smokey_cornell_box {cfg.width}x"
          f"{cfg.height} spp {cfg.samples_per_pixel} depth {cfg.max_depth} "
          f"(K5-emit, then torch autograd of the replay) on {smi}: frame "
          f"{fb_ms:.3f} ms, {segs / (fb_ms / 1e3):.4e} segments/s; every "
          f"gradient finite", flush=True)

    from raytracer_weekend_tpu_torch import integrator

    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    tids = scene.materials.tex[scene.volumes.mat.long()].long()
    color1 = scene.textures.color1.clone()
    color1[tids] += 0.2
    start = scene._replace(textures=scene.textures._replace(color1=color1))
    mk.VOL_LAUNCHES = mk.EMIT_LAUNCHES = rb.LAUNCHES = 0
    hist, step_ms = fit_three_steps(static, cfg, cam, target, start)
    fit_counts = (mk.VOL_LAUNCHES, mk.EMIT_LAUNCHES, rb.LAUNCHES)
    if min(fit_counts[:2]) < 1 or fit_counts[2] != 0:
        raise AssertionError(f"smokey fit: K5/K5-emit/K2 launches "
                             f"{fit_counts}")
    print(f"phase 13 training path: InverseRenderer.fit smokey_cornell_box "
          f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
          f"{cfg.max_depth}, 3 Adam steps from the media's albedo + 0.2 on "
          f"{smi}: {fit_counts[1]} K5-emit launches, none of K2; loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f})", flush=True)

    b_scene, b_static, b_cfg, b_cam = load_scene("book2_final_scene",
                                                 BOOK2_DIFF, dev)
    _, b_seg = mk.render_fused(b_scene, b_cfg, b_cam, 0, b_cfg.n_rays,
                               b_cfg.seed, static=b_static)
    torch.cuda.reset_peak_memory_stats(dev)
    b_ms, b_grads = fwd_bwd_ms(b_scene, b_static, b_cfg, b_cam)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not any(bool(g.any()) for g in b_grads):
        raise AssertionError("book2 forward+backward: all-zero gradients")
    segs = int(b_seg.sum())
    print(f"phase 13 forward+backward book2_final_scene {b_cfg.width}x"
          f"{b_cfg.height} spp {b_cfg.samples_per_pixel} depth "
          f"{b_cfg.max_depth} (K5-emit with K6a and the combine, then torch "
          f"autograd of the replay, its turbulence through the plain "
          f"autograd) on {smi}: frame {b_ms:.3f} ms, {segs / (b_ms / 1e3):.4e}"
          f" segments/s, peak memory {peak:.2f} GiB; every gradient finite",
          flush=True)


# ---- the staged path: K10, K11, K12 (phase 14) --------------------------------

# The closest-hit kernels are held to their plain versions with the budgets
# of `ops.cuda.checks.hit_budgets`.
# FP32 operations per ray-primitive pair (the JAX CostEstimates:
# sphere_intersect.py:149, rect_intersect.py:114, triangle_intersect.py:134).
OPS_PAIR = {"spheres": 40, "rects": 30, "triangles": 45}
# What K10 and K12 do where their work depends on the data, counted from
# csrc/intersect.cu (an FMA two, a division, square root or compare one):
# K10 41 for each valid pair (disc and its test) and 8 more where disc > 0
# (the square root, the two roots, their tests); K12 48 for each valid pair
# (det and the three numerators 33, the division-free prefilter 15) and 12
# more for each candidate (1 / det, u, v, t, u + v and the exact test's
# compares). K11 does OPS_PAIR's 30 on every pair.
OPS_SPHERE_PAIR, OPS_SPHERE_ROOTS = 41, 8
OPS_TRI_PAIR, OPS_TRI_CAND = 48, 12
# Bytes per ray the kernels move (rays in, t and idx out), and the floats of
# one primitive's terms (the packed tables pad them to 16 and 20).
BYTES_RAY = {"spheres": 48, "rects": 32, "triangles": 44}
TERMS_ROW = {"spheres": 13, "rects": 7, "triangles": 17}
# The whole-frame launches (render_image and the fits) of each kernel are
# timed on the primary rays of one scene; the staged frames' on their own.
TIMED = {"spheres": "jumpy_balls", "rects": "cornell_box",
         "triangles": "wavefront_cow_obj"}
STAGED_CHUNK = 1 << 18
FULL_RAYS = 400 * 225 * 16
# The uv-debug jumpy's fit holds the whole frame's staged autograd graph.
STAGED_FIT = dict(width=400, height=225, samples_per_pixel=16, max_depth=8)
MANY_SMALL = dict(width=64, height=36, samples_per_pixel=4, max_depth=6)
# The closest-hit Functions' VJP on the card against their route in
# float64, per leaf (norm_rel), for a random cotangent on t. The winner
# recompute in float32 (the JAX custom_vjp's) loses digits to cancellation:
# rects and triangles few (measured at most 3.0e-4, the cow's vertices),
# spheres many (disc = hb^2 - |d|^2 c is about r^2 / |o - c|^2 of hb^2 for
# a small sphere far away, and less near its rim; measured at most 0.111,
# the t0 of jumpy's spheres, on an H100 80GB HBM3 at 700 W). Held to about
# twice that, or K2's 1e-3.
VJP_NORM_REL = {"spheres": 0.25, "rects": 1e-3, "triangles": 1e-3}


def row_reads(tab, idx, smi):
    """Forward+backward of reading the winners' rows `tab[idx]` (the
    backward sorts the ids and adds each row's duplicates one after
    another) against `textures._rows` (`index_select`, whose backward is an
    atomic `index_add_`, for a table of more than 8 rows), by CUDA events;
    raises unless `_rows`, which the hit records and K10-K12's backward
    read rows with, is the faster."""
    import torch

    from raytracer_weekend_tpu_torch import textures

    leaf = tab.detach().clone().requires_grad_()
    ct = torch.rand((idx.shape[0], *tab.shape[1:]), device=tab.device)
    times = {}
    for how, read in (("tab[idx]", lambda: leaf[idx]),
                      ("textures._rows", lambda: textures._rows(leaf, idx))):
        def fb():
            return torch.autograd.grad(read(), leaf, ct)
        fb()
        times[how] = cuda_ms(fb, 5)
    print(f"phase 14 reading the winners' rows (jumpy's primary K10 winners,"
          f" {idx.shape[0]} reads of a {tab.shape[0]}-row table), "
          f"forward+backward ms: {json.dumps(times)} (median of 5; {smi})",
          flush=True)
    if not times["textures._rows"] < times["tab[idx]"]:
        raise AssertionError(f"textures._rows is not the faster: {times}")


def staged_profile(scene, static, cfg, cam, smi):
    """torch.profiler over one chunk of the whole frame through the staged
    path, forward alone and forward+backward (the radiance sum over every
    float leaf): host and device time, K10's and index_add_'s device time;
    raises unless the profiler saw K10 run on the device in both."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    leaves = [le.detach().clone() for le in scene.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    diff = SceneData.from_leaves(leaves, scene.trees)
    ids = torch.arange(cfg.n_rays, device=scene.device)

    def fwd():
        with torch.no_grad():
            return integrator.render_chunk(scene, static, cfg, cam, ids,
                                           cfg.seed)

    def fwd_bwd():
        rad = integrator.render_chunk(diff, static, cfg, cam, ids, cfg.seed)
        return torch.autograd.grad(rad.sum(), floats, allow_unused=True)

    out = {}
    for what, fn in (("forward", fwd), ("forward+backward", fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        # Kernels are the events on the device (as the profiler's own table
        # sums them); an operator's self device time is its kernels'.
        kernels = [e for e in ev if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        out[what] = dict(
            host_ms=sum(e.self_cpu_time_total for e in ev) / 1e3,
            device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
            k10_ms=sum(e.self_device_time_total for e in kernels
                       if "hit_spheres_kernel" in e.key) / 1e3,
            index_add_ms=sum(e.self_device_time_total for e in ev
                             if e.key == "aten::index_add_") / 1e3)
    print(f"phase 14 profile of the staged path, jumpy_balls_uvdebug "
          f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
          f"{cfg.max_depth} in one chunk (torch.profiler, self times summed;"
          f" {smi}): {json.dumps(out)}", flush=True)
    if not all(v["k10_ms"] > 0.0 for v in out.values()):
        raise AssertionError(f"the profiler saw no K10 on the device: {out}")


def hit_family(kind):
    """(kernel module, its autograd.Function, the plain version, the
    kernel's table builder, the winner recompute of its backward (table,
    rays, idx, t_min) -> t)."""
    from raytracer_weekend_tpu_torch.ops import rect, sphere, triangle
    from raytracer_weekend_tpu_torch.ops.cuda import (
        rect_intersect, sphere_intersect, triangle_intersect)

    return {
        "spheres": (sphere_intersect, sphere_intersect.hit_spheres_kernel,
                    sphere.hit_spheres, sphere_intersect.sphere_table,
                    lambda tb, r, idx, t_min: sphere_intersect._winning_root(
                        tb, *r, idx, t_min)),
        "rects": (rect_intersect, rect_intersect.hit_rects_kernel,
                  rect.hit_rects, rect_intersect.rect_table,
                  lambda tb, r, idx, t_min: rect_intersect._winning_t(
                      tb, *r, idx)),
        "triangles": (triangle_intersect,
                      triangle_intersect.hit_triangles_kernel,
                      triangle.hit_triangles,
                      triangle_intersect.triangle_table,
                      lambda tb, r, idx, t_min: triangle_intersect._winning_t(
                          tb, *r, idx)),
    }[kind]


def hit_rays(kind, rays):
    return rays if kind == "spheres" else rays[:2]


def plain_hits(kind, tab, rays, window, t_min=1e-3):
    """The plain brute force in windows of `window` rays -> (t, idx)."""
    import torch

    plain = hit_family(kind)[2]
    n = rays[0].shape[0]
    with torch.no_grad():
        parts = [plain(tab, *(r[w] for r in hit_rays(kind, rays)), t_min)
                 for w in lane_windows(n, window)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def disc_positive(sp, rays, window):
    """The valid ray-sphere pairs with disc > 0, where K10 takes the roots,
    by the plain version's arithmetic (`ops.sphere.hit_spheres`), in
    windows of `window` rays."""
    import torch

    from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops

    dc, dt, r2, c0_sq, c0_dc, dc_sq = sphere_ops.sphere_terms(sp)
    total = 0
    with torch.no_grad():
        for win in lane_windows(rays[0].shape[0], window):
            o, d, time = (r[win] for r in rays)
            w = (time[:, None] - sp.t0[None, :]) / dt[None, :]
            a, od, oo = (x[:, None] for x in sphere_ops.ray_terms(o, d))
            half_b = od - (d @ sp.c0.T + w * (d @ dc.T))
            c_term = (oo - 2.0 * (o @ sp.c0.T + w * (o @ dc.T))
                      + (c0_sq + 2.0 * w * c0_dc + w * w * dc_sq) - r2)
            disc = half_b * half_b - a * c_term
            total += int(((disc > 0.0) & sp.valid[None, :]).sum())
    return total


def hit_ops(kind, tab, rays, window):
    """(FP32 operations of one launch of K10-K12 on these rays and table,
    the counts they were taken from): per pair, and for K10 and K12 per
    valid pair plus the data's share, the pairs with disc > 0 (K10) or the
    candidates its counting launch finds (K12). K10's counts also give the
    share of its valid pairs on a static sphere (c1 == c0)."""
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti

    n, P = rays[0].shape[0], tab.valid.shape[0]
    if kind == "rects":
        return n * P * OPS_PAIR[kind], {"pairs": n * P}
    valid = n * int(tab.valid.sum())
    if kind == "spheres":
        roots = disc_positive(tab, rays, window)
        static = int((tab.valid & (tab.c1 == tab.c0).all(1)).sum())
        return (valid * OPS_SPHERE_PAIR + roots * OPS_SPHERE_ROOTS,
                {"valid pairs": valid, "disc > 0": roots,
                 "static share of valid pairs (c1 == c0)":
                     static / max(int(tab.valid.sum()), 1)})
    cands = ti.count_divisions(ti.triangle_table(tab),
                               ti.ray_operands(*rays[:2]), 1e-3)
    return (valid * OPS_TRI_PAIR + cands * OPS_TRI_CAND,
            {"valid pairs": valid, "candidates": cands})


def check_hits(what, t_k, i_k, t_p, i_p):
    """hit_budgets -> its stats; raises when they are exceeded."""
    from raytracer_weekend_tpu_torch.ops.cuda import checks

    stats = checks.hit_budgets(t_k, i_k, t_p, i_p)
    if not stats.pop("ok"):
        raise AssertionError(f"{what}: kernel vs plain outside budgets: "
                             f"{stats}")
    return stats


def hit_vjp(what, kind, tab, rays, t_min, window):
    """The kernel's autograd.Function on the card (K10-K12's winners, then
    autograd of the winner recompute in float32) for a random cotangent on
    t, leaf by leaf (norm_rel; the entries that are zero in the reference
    stay within K2_ZERO of its largest), against its route on the CPU, the
    plain forward then the same recompute, run in float64 (on the card, the
    plain forward in windows of `window` rays): VJP_NORM_REL of the kind.
    Held out first, at most n // HELD_OUT lanes: those whose float64
    winner differs (near-ties), and the ill-conditioned ones, whose
    float64 ray cotangents move by more than ILL_REL of the lane's largest
    (plus K2_ZERO of the largest of any lane) when the rays move by one
    float32 ulp. Raises beyond the budgets; -> stats."""
    import torch

    kern, recompute = hit_family(kind)[1], hit_family(kind)[4]
    n, dev = rays[0].shape[0], rays[0].device
    names = [f for f, x in zip(type(tab)._fields, tab)
             if x.is_floating_point()] + ["o", "d", "time"][:len(
                 hit_rays(kind, rays))]

    def leaves(dtype, rs):
        tb = type(tab)(*(f.detach().to(dtype).requires_grad_()
                         if f.is_floating_point() else f for f in tab))
        rs = tuple(r.detach().to(dtype).requires_grad_()
                   for r in hit_rays(kind, rs))
        return tb, rs, [f for f in tb if f.requires_grad] + list(rs)

    def route(dtype, rs, idx, ct):
        tb, r, wrt = leaves(dtype, rs)
        return torch.autograd.grad(recompute(tb, r, idx, t_min), wrt,
                                   ct.to(dtype), allow_unused=True)

    def compare(got, ref, limit):
        scale = max(float(g.abs().max()) for g in ref if g is not None)
        rel, ok = {}, True
        for name, a, b in zip(names, got, ref):
            if b is None or not bool((b != 0).any()):
                continue
            a = torch.zeros_like(b) if a is None else a
            zero = float(torch.where(b == 0, a.double().abs(), 0.0).max())
            rel[name] = norm_rel(a, b)
            ok = (ok and bool(torch.isfinite(a).all()) and rel[name] <= limit
                  and zero <= K2_ZERO * scale)
        return rel, ok

    tb32, r32, wrt32 = leaves(torch.float32, rays)
    t32, i32 = kern(tb32, *r32, t_min)
    tb64, r64, _ = leaves(torch.float64, rays)
    t64, i64 = plain_hits(kind, tb64, r64, window, t_min)
    same = ((i32.long() == i64)
            & (torch.isfinite(t32) == torch.isfinite(t64)))
    gen = torch.Generator(device=dev).manual_seed(15)
    ct = torch.randn(n, device=dev, generator=gen)
    ct = torch.where(same & torch.isfinite(t32), ct, 0.0)
    # The same rays moved by one float32 ulp, each component up or down.
    jit = [x.double() * (1.0 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, x.shape, device=dev, generator=gen) - 1)) for x in rays[:2]]

    def lanes(g):
        return torch.cat([g[i].reshape(n, -1).double()
                          for i in range(len(names) - len(r32), len(names))],
                         dim=1)

    wit = lanes(route(torch.float64, rays, i64, ct))
    top = wit.abs().amax(dim=1)
    ill = ((lanes(route(torch.float64, (*jit, *rays[2:]), i64, ct))
            - wit).abs().amax(dim=1)
           > ILL_REL * top + K2_ZERO * float(top.max()))

    def card(ct):
        return torch.autograd.grad(t32, wrt32, ct, allow_unused=True,
                                   retain_graph=True)

    all_lanes = compare(card(ct), route(torch.float64, rays, i64, ct),
                        float("inf"))[0]
    ct = torch.where(ill, 0.0, ct)
    rel, ok = compare(card(ct), route(torch.float64, rays, i64, ct),
                      VJP_NORM_REL[kind])
    held = int((~same | ill).sum())
    stats = dict(rays=n, hits=int(torch.isfinite(t32).sum()),
                 held_out=dict(near_ties=int((~same).sum()),
                               ill_conditioned=int(ill.sum()), total=held,
                               budget=max(4, n // HELD_OUT)),
                 norm_rel=rel, all_lanes=all_lanes)
    print(f"phase 14 VJP of {what} vs float64 (budget norm_rel "
          f"{VJP_NORM_REL[kind]}): {json.dumps(stats)}", flush=True)
    if not ok or held > max(4, n // HELD_OUT):
        raise AssertionError(f"{what} VJP: {stats}")
    return stats


def tri_candidate_check(dev):
    """K12's division-free prefilter (tri_candidate in csrc/intersect.cu)
    against the exact test on the card: for each t_min of
    checks.CAND_T_MINS, checks.tri_candidate_cases' adversarial set plus
    2^24 random cases; it must pass every case the exact test accepts, and
    give its plain twin's bits on every case."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import checks
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti

    out = []
    for t_min in checks.CAND_T_MINS:
        cases = [torch.from_numpy(x).to(dev) for x in
                 checks.tri_candidate_cases(t_min, 1 << 24, seed=12)]
        *nums, best = cases
        got = ti.tri_candidate_device(*nums, best, t_min)
        exact = checks.tri_exact_accepts(*nums, t_min, best)
        twin = ti.tri_candidate_plain(*(x.cpu() for x in nums), t_min,
                                      best.cpu())
        missed = int((exact & ~got).sum())
        differ = int((got.cpu() != twin).sum())
        out.append(dict(t_min=t_min, cases=best.numel(),
                        exact=int(exact.sum()), passed=int(got.sum()),
                        missed=missed, differ_from_twin=differ))
        if missed or differ:
            raise AssertionError(f"tri_candidate: {out[-1]}")
    print(f"phase 14 K12's prefilter on the card, adversarial cases + 2^24 "
          f"random ones per t_min: a superset of the exact test, its plain "
          f"twin's bits: {json.dumps(out)}", flush=True)


def intersect_design(log):
    """K10's, K11's and K12's launch configuration and the registers of
    their instantiations (ptxas); raises if one spills."""
    from raytracer_weekend_tpu_torch.ops.cuda import rect_intersect as ri
    from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as si
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti

    regs = [r for r in ptxas_registers(log)
            if r.startswith(("hit_spheres_kernel", "hit_rects_kernel",
                             "hit_triangles_kernel"))]
    print(f"phase 14 K10, K11 and K12 as compiled: rays a thread, block, "
          f"tile rows: K10 {(si.RAYS, si.BLOCK, si.TILE)}, K11 "
          f"{(ri.RAYS, ri.BLOCK, ri.TILE)}, K12 "
          f"{(ti.RAYS, ti.BLOCK, ti.TILE)}; registers (ptxas, K12's "
          f"<count>): {' | '.join(regs)}", flush=True)
    if len(regs) < 4 or any("spills" in r for r in regs):
        raise AssertionError(f"K10-K12 instantiations spill or are missing: "
                             f"{regs}")


def divide_share(what, tab, rays, t_min):
    """The share of ray-triangle pairs of one K12 launch that took the
    division (the counting instantiation), printed."""
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti

    table = ti.triangle_table(tab)
    divides = ti.count_divisions(table, ti.ray_operands(*rays[:2]), t_min)
    pairs = rays[0].shape[0] * int(tab.valid.sum())
    print(f"phase 14 K12 prefilter, {what} rays: {divides} of {pairs} valid "
          f"pairs took the division ({divides / max(pairs, 1):.4e})",
          flush=True)


def rect_tiles_check(dev):
    """K11 on 1,000 random rects (8 tiles of kRectTile: walk_tiles' double
    buffer) and 2^16 rays, bit for bit its plain version and its plain twin
    (`hit_rects_twin` on the CPU, the first 4,096 rays), at t_min 1e-3, 7,
    0 and -0.5."""
    import torch

    from raytracer_weekend_tpu_torch.ops import rect
    from raytracer_weekend_tpu_torch.ops.cuda import checks
    from raytracer_weekend_tpu_torch.ops.cuda import rect_intersect as ri

    tab, (o, d, _) = checks.random_hit_case("rects", dev, 1 << 16,
                                            rows=1000)
    table, ops = ri.rect_table(tab), ri.ray_operands(o, d)
    cpu = type(tab)(*(x.cpu() for x in tab))
    out = []
    for t_min in (1e-3, 7.0, 0.0, -0.5):
        t, idx = ri._launch(table, ops, t_min)
        want_t, want_i = rect.hit_rects(tab, o, d, t_min)
        tw_t, tw_i = ri.hit_rects_twin(cpu, o[:4096].cpu(), d[:4096].cpu(),
                                       t_min)
        row = dict(t_min=t_min, hits=int(torch.isfinite(t).sum()),
                   plain_bitwise=bool(torch.equal(t, want_t) and torch.equal(
                       idx.long(), want_i)),
                   twin_bitwise=bool(torch.equal(t[:4096].cpu(), tw_t)
                                     and torch.equal(idx[:4096].cpu(), tw_i)))
        out.append(row)
        if not (row["plain_bitwise"] and row["twin_bitwise"]):
            raise AssertionError(f"K11 on {tab.k.shape[0]} rects: {row}")
    print(f"phase 14 K11 on {tab.k.shape[0]} random rects ({ri.TILE}-row "
          f"tiles), {o.shape[0]} rays, bit for bit its plain version and "
          f"its twin: {json.dumps(out)}", flush=True)


def bounce_rays(scene, static, cfg, cam):
    """The frame's primary rays and its first-bounce rays (the live lanes'
    scattered rays after one bounce of the staged path) -> two (o, d,
    time) triples."""
    import dataclasses

    from raytracer_weekend_tpu_torch import integrator

    import torch

    ids = torch.arange(cfg.n_rays, device=scene.device)
    o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
    *_, (o1, d1, _, _, alive, _) = integrator.trace_lanes(
        scene, static, dataclasses.replace(cfg, max_depth=1), o, d, t, rid,
        cfg.seed, return_carry=True)
    return (o, d, t), (o1[alive].contiguous(), d1[alive].contiguous(),
                       t[alive].contiguous())


def staged_path(dev, smi):
    """Phase 14: the staged path on the card. K10, K11 and K12 against
    their plain versions on real rays (the primary and first-bounce rays of
    jumpy_balls, cornell_box and the cow) and on 100k random rays against
    random tables, and their autograd.Functions' VJP against float64 on the
    real rays; the staged frame (render_chunk's route in 2^18-lane chunks)
    of the three scenes against the fused path's segments and radiance,
    and through use_pallas=False; render_image and 3 Adam steps of
    InverseRenderer.fit on jumpy_balls with a uv-debug ground (outside
    fused_supported: K10), 3 steps on jumpy_balls with an isotropic sphere
    (K10); render_image and 3 steps on smokey_cornell_box with a checker
    albedo (K11 and the plain medium test); K2 with d(ktab) reduced by
    global atomics on 3,970 spheres. Each main-path run (the three staged
    frames, the two render_image calls, the four fits) counts its launches
    from 0 and is read just after; the kernels line's K10, K11 and K12
    entries, which this returns, sum those counts."""
    import dataclasses

    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.ops.cuda import _build, checks
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.scene.data import without_trees

    mods = {k: hit_family(k)[0] for k in ("spheres", "rects", "triangles")}
    # (kind, scene whose rays it was timed on, rays a launch) -> launches.
    launches = {}

    def main_path(run, scene_name="", chunk=FULL_RAYS):
        """run() with every K10-K12 count reset just before and read just
        after -> (run()'s result, the counts), added to `launches` under
        the launch size `chunk`; the staged frames' launches also under
        their scene, the whole-frame launches (render_image and the fits)
        under each kernel's TIMED scene."""
        for m in mods.values():
            m.LAUNCHES = 0
        out = run()
        counts = {k: m.LAUNCHES for k, m in mods.items()}
        for k, c in counts.items():
            if c:
                key = (k, scene_name or TIMED[k], chunk)
                launches[key] = launches.get(key, 0) + c
        return out, counts

    # ---- 14a. each kernel against its plain version --------------------------
    windows = {"jumpy_balls": PLAIN_CHUNK, "cornell_box": PLAIN_CHUNK,
               "wavefront_cow_obj": 1 << 14}
    fams = {"jumpy_balls": ("spheres",), "cornell_box": ("rects", "triangles"),
            "wavefront_cow_obj": ("triangles",)}
    errs, frames, timed = {}, {}, {}
    for name in ("jumpy_balls", "cornell_box", "wavefront_cow_obj"):
        # The cow without its tree: K12's brute force (phase 15 walks it).
        scene, static, cfg, cam = load_scene(name, FULL, dev)
        scene, static = without_trees(scene, static)
        frames[name] = (scene, static, cfg, cam)
        primary, bounce = bounce_rays(scene, static, cfg, cam)
        for kind in ("spheres", "rects", "triangles"):
            if getattr(static, f"n_{kind}"):
                timed[kind, name] = (getattr(scene, kind), primary,
                                     windows[name])
        for kind in fams[name]:
            mod, kern = hit_family(kind)[:2]
            tab = getattr(scene, kind)
            for which, rays in (("primary", primary), ("first bounce", bounce)):
                t_k, i_k = kern(tab, *hit_rays(kind, rays), cfg.t_min)
                t_p, i_p = plain_hits(kind, tab, rays, windows[name],
                                      cfg.t_min)
                torch.cuda.synchronize()
                stats = check_hits(f"{kind} {name} {which}", t_k, i_k, t_p,
                                   i_p)
                print(f"phase 14 {mod.__name__.rsplit('.', 1)[1]} vs plain "
                      f"{name} {which} rays: {json.dumps(stats)}", flush=True)
                if name != "jumpy_balls":     # K10's: on the uv-debug jumpy
                    hit_vjp(f"{kind} {name} {which} rays", kind, tab, rays,
                            cfg.t_min, windows[name])
                if kind == "triangles":
                    divide_share(f"{name} {which}", tab, rays, cfg.t_min)
                errs[kind] = max(errs.get(kind, 0.0), stats["max_abs_err"])
                if (name, which) == ("jumpy_balls", "primary"):
                    row_reads(tab.c0, i_k.long(), smi)
    tri_candidate_check(dev)
    rect_tiles_check(dev)
    intersect_design(_build.library_path().with_name(
        _build.library_path().name + ".log").read_text())
    for kind in ("spheres", "rects", "triangles"):
        tab, rays = checks.random_hit_case(kind, dev, 100_000)
        kern = hit_family(kind)[1]
        t_k, i_k = kern(tab, *hit_rays(kind, rays), 1e-3)
        t_p, i_p = plain_hits(kind, tab, rays, 1 << 14)
        torch.cuda.synchronize()
        stats = check_hits(f"{kind} random", t_k, i_k, t_p, i_p)
        print(f"phase 14 {kind} vs plain, random table of "
              f"{tab.valid.shape[0]} rows (moving, hollow, invalid rows; "
              f"axis-parallel rays): {json.dumps(stats)}", flush=True)
        errs[kind] = max(errs[kind], stats["max_abs_err"])

    # ---- 14b. the staged frame end to end -------------------------------------
    for name, budgets in (("jumpy_balls", SPHERE_BUDGETS),
                          ("cornell_box", PLANAR_BUDGETS),
                          ("wavefront_cow_obj", PLANAR_BUDGETS)):
        scene, static, cfg, cam = frames[name]
        f_rad, f_seg = mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static)
        (rad, seg), counts = main_path(lambda: staged_frame(
            scene, static, cfg, cam, STAGED_CHUNK), name, STAGED_CHUNK)
        torch.cuda.synchronize()
        ok, stats = _budgets(rad, f_rad, seg.sum(), f_seg.sum(), cfg.n_rays,
                             **budgets)
        stats.update(staged_segments=int(seg.sum()),
                     fused_segments=int(f_seg.sum()), launches=counts)
        if not ok or min(counts[k] for k in fams[name]) < 1:
            raise AssertionError(f"staged {name} vs fused: {stats}")
        frame_ms = [cuda_ms(lambda: staged_frame(scene, static, cfg, cam,
                                                  STAGED_CHUNK), 1)
                    for _ in range(3)]
        # The staged path launches some 400 small torch operations a bounce
        # and chunk; one chunk of the whole frame (render_image's default)
        # pays that host cost once.
        whole_ms = cuda_ms(lambda: staged_frame(scene, static, cfg, cam,
                                                 cfg.n_rays), 3)
        plain_ms = cuda_ms(lambda: plain_staged(scene, static, cfg, cam,
                                                 windows[name]), 1)
        med = statistics.median(frame_ms)
        segs = int(seg.sum())
        print(f"phase 14 staged frame {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel} depth {cfg.max_depth} "
              f"({STAGED_CHUNK}-lane chunks) vs the fused path: "
              f"{json.dumps(stats)}; frame {med:.3f} ms ({frame_ms}), "
              f"{segs / (med / 1e3):.4e} segments/s; in one chunk "
              f"{whole_ms:.3f} ms, {segs / (whole_ms / 1e3):.4e} "
              f"segments/s; plain (use_pallas="
              f"False, {windows[name]}-lane windows) {plain_ms:.3f} ms "
              f"({smi})", flush=True)

    # ---- 14c. a scene outside fused_supported: render_image and fit -----------
    scene, static, cfg, cam = load_scene("jumpy_balls_uvdebug", FULL, dev)
    if mk.fused_supported(static, cfg):
        raise AssertionError("jumpy_balls_uvdebug is fused_supported")
    for which, rays in zip(("primary", "first bounce"),
                           bounce_rays(scene, static, cfg, cam)):
        hit_vjp(f"spheres jumpy_balls_uvdebug {which} rays", "spheres",
                scene.spheres, rays, cfg.t_min, PLAIN_CHUNK)
    with torch.no_grad():
        ids = torch.arange(cfg.n_rays, device=dev)
        k_rad = integrator.render_chunk(scene, static, cfg, cam, ids,
                                        cfg.seed)
    mk.LAUNCHES = 0
    (frame_ms, png), counts = main_path(lambda: time_render_image(
        "jumpy_balls_uvdebug", scene, static, cfg, cam, k_rad))
    if counts["spheres"] < 1 or mk.LAUNCHES:
        raise AssertionError(f"render_image(jumpy_balls_uvdebug): launches "
                             f"{counts}, {mk.LAUNCHES} of the megakernel")
    print(f"phase 14 main path: render_image jumpy_balls_uvdebug {cfg.width}"
          f"x{cfg.height} spp {cfg.samples_per_pixel} depth {cfg.max_depth} "
          f"(staged, outside fused_supported) on {smi}: {counts['spheres']} "
          f"K10 launches (1 warm-up and 10 frames), median frame "
          f"{statistics.median(frame_ms):.3f} ms (min {min(frame_ms):.3f}, "
          f"max {max(frame_ms):.3f}); image -> {png}", flush=True)
    staged_profile(scene, static, cfg, cam, smi)

    # InverseRenderer.fit moves every float leaf. With a uv-debug ground the
    # spheres' geometry gets gradients (of the radiance along fixed paths),
    # and Adam's first steps move each centre and radius by about the
    # learning rate, which moves occlusion and reflection edges: the loss
    # rises, through the plain brute force as through K10. So this fit is
    # timed and held to finite gradients and parameters (its geometry
    # gradients are held to float64 by hit_vjp above), and the falling loss
    # is checked on two scenes outside the megakernel whose geometry
    # gradients are 0: jumpy_balls with its metal sphere made isotropic
    # (K10) and the checker-albedo smokey (K11).
    fcfg = dataclasses.replace(cfg, **STAGED_FIT)
    target, start = fit_inputs(scene, static, fcfg, cam)
    from raytracer_weekend_tpu_torch.scene.data import SceneData
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    leaves = [le.detach().clone() for le in start.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    torch.cuda.reset_peak_memory_stats(dev)
    loss = InverseRenderer(static, fcfg, cam, target).loss(
        SceneData.from_leaves(leaves, start.trees))
    grads = torch.autograd.grad(loss, floats, allow_unused=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(bool(torch.isfinite(g).all()) for g in grads if g is not None):
        raise AssertionError("staged fit: non-finite gradients")
    g_c0 = float(grads[0].abs().max())        # the sphere centres
    if g_c0 == 0.0:
        raise AssertionError("staged fit: no sphere-centre gradient")
    mk.EMIT_LAUNCHES = 0
    (hist, step_ms), counts = main_path(lambda: fit_three_steps(
        static, fcfg, cam, target, start, falling=False))
    if counts["spheres"] < 1 or mk.EMIT_LAUNCHES:
        raise AssertionError(f"staged fit: launches {counts}, or the "
                             f"megakernel launched")
    print(f"phase 14 training path: InverseRenderer.fit jumpy_balls_uvdebug "
          f"{fcfg.width}x{fcfg.height} spp {fcfg.samples_per_pixel} depth "
          f"{fcfg.max_depth} (staged under autograd), 3 Adam steps from "
          f"color1 + 0.2 on {smi}: {counts['spheres']} K10 launches; loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f}); every gradient finite, "
          f"sphere centres' largest {g_c0:.3e}; peak memory of one loss + "
          f"gradient {peak:.2f} GiB", flush=True)

    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.scene import builder

    objs, cams, bg = scenes.jumpy_balls(cfg.aspect_ratio)
    objs[4] = dataclasses.replace(objs[4], material=builder.Isotropic(
        (0.7, 0.6, 0.5)))                     # the metal sphere at (4, 1, 0)
    scene, static = builder.build_scene(objs, background=bg)
    scene, cam = scene.to(dev), cams[0].to(dev)
    if mk.fused_supported(static, cfg):
        raise AssertionError("an isotropic sphere is fused_supported")
    target, start = fit_inputs(scene, static, fcfg, cam)
    (hist, step_ms), counts = main_path(lambda: fit_three_steps(
        static, fcfg, cam, target, start))
    if counts["spheres"] < 1:
        raise AssertionError("isotropic jumpy fit: no K10 launch")
    print(f"phase 14 training path: InverseRenderer.fit jumpy_balls with an "
          f"isotropic sphere (staged, geometry gradients 0) {fcfg.width}x"
          f"{fcfg.height} spp {fcfg.samples_per_pixel} depth "
          f"{fcfg.max_depth}, 3 Adam steps from color1 + 0.2 on {smi}: "
          f"{counts['spheres']} K10 launches; loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f})", flush=True)

    # ---- 14d. a planar scene outside fused_supported ---------------------------
    scene, static, cfg, cam = load_scene("smokey_checker_medium", FULL, dev)
    if mk.fused_supported(static, cfg):
        raise AssertionError("smokey_checker_medium is fused_supported")

    def timed_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = integrator.render_image(scene, static, cfg, cam)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (img, s_ms), render_counts = main_path(timed_render)
    if (render_counts["rects"] < 1 or not bool(torch.isfinite(img).all())
            or not img.any()):
        raise AssertionError(f"render_image(smokey_checker_medium): launches "
                             f"{render_counts}, or a bad image")
    target = img / cfg.samples_per_pixel
    tids = scene.materials.tex[scene.volumes.mat.long()].long()
    color1 = scene.textures.color1.clone()
    color1[tids] += 0.2
    start = scene._replace(textures=scene.textures._replace(color1=color1))
    (hist, step_ms), counts = main_path(lambda: fit_three_steps(
        static, cfg, cam, target, start))
    if counts["rects"] < 1:
        raise AssertionError("smokey_checker_medium fit: no K11 launch")
    print(f"phase 14 main path: render_image smokey_checker_medium "
          f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
          f"{cfg.max_depth} (staged: K11 and the plain medium test) on {smi}:"
          f" {render_counts['rects']} K11 launches, one frame {s_ms:.3f} ms;"
          f" InverseRenderer.fit 3 Adam steps from the media's albedo + 0.2:"
          f" {counts['rects']} K11 launches, loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} (median after warm-up "
          f"{statistics.median(step_ms[1:]):.3f})", flush=True)
    by_key = {" ".join(map(str, k)): v for k, v in launches.items()}
    print(f"phase 14 launches on the main paths (staged frames, render_image,"
          f" fits; each counted from 0), by kernel, table and rays a launch:"
          f" {json.dumps(by_key)}", flush=True)
    many_spheres_k2(dev, smi)
    return [hit_entry(kind, name, chunk, count, *timed[kind, name],
                      errs[kind], smi)
            for (kind, name, chunk), count in sorted(launches.items())]


def hit_entry(kind, name, chunk, launches, tab, rays, window, err, smi):
    """The kernels line's entry of K10, K11 or K12 for the launches of
    `chunk` rays against scene `name`'s table, on the first `chunk` of its
    primary rays (medians of 5): `ms` and `event_ms` the launch alone, on
    the table and ray operands built beforehand (`launch_times`);
    `wrapper_ms` the autograd.Function's call as the staged path makes it
    (its table built once per trace and passed in) less `event_ms`, both
    by CUDA events; the plain version once;
    the bound at that size (`hit_ops`), and beside it in the print the
    bound of the JAX CostEstimate's count (OPS_PAIR on every pair). The
    table's build (once per trace) is printed."""
    mod, kern, _, build = hit_family(kind)[:4]
    full = tuple(r[:chunk] for r in rays)
    part = hit_rays(kind, full)
    n, P = part[0].shape[0], tab.valid.shape[0]
    table = build(tab)
    ops = mod.ray_operands(*part)
    l_ms, l_ev = launch_times(lambda: mod._launch(table, ops, 1e-3))
    f_ms = cuda_ms(lambda: kern(tab, *part, 1e-3, table=table), 5)
    b_ms = cuda_ms(lambda: build(tab), 5)
    p_ms = cuda_ms(lambda: plain_hits(kind, tab, full, window), 1)
    ops, counts = hit_ops(kind, tab, full, window)
    short = mod.__name__.rsplit(".", 1)[1]
    print(f"phase 14 timing {short} {name} primary: {n} rays x {P} rows, "
          f"launch {l_ms:.4f} ms on the device ({l_ev:.4f} by events), "
          f"Function call {f_ms:.3f} ms (wrapper {f_ms - l_ev:.3f}), table "
          f"build {b_ms:.3f} ms once a trace, "
          f"plain {p_ms:.3f} ms (median; {smi}); {launches} launches of "
          f"this size on the main paths; {ops:.4e} FP32 operations "
          f"({json.dumps(counts)}), bound {ops / FP32_PEAK * 1e3:.4f} ms, "
          f"by the JAX CostEstimate's {OPS_PAIR[kind]} a pair "
          f"{n * P * OPS_PAIR[kind] / FP32_PEAK * 1e3:.4f} ms", flush=True)
    return bound({
        "name": f"{short}[{name} {n} rays]",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/intersect.cu",
        "replaces": "raytracer_weekend_tpu/ops/pallas/"
                    + {"spheres": "sphere_intersect.py:39",
                       "rects": "rect_intersect.py:34",
                       "triangles": "triangle_intersect.py:36"}[kind],
        "launches": launches,
        "max_abs_err": err,
        "ms": l_ms,
        "event_ms": l_ev,
        "wrapper_ms": f_ms - l_ev,
        "plain_ms": p_ms,
    }, ops, n * BYTES_RAY[kind] + 4 * TERMS_ROW[kind] * P)


def many_spheres_k2(dev, smi):
    """Phase 14e: K2 on many_spheres (3,970 spheres on jumpy_balls' checker
    ground), whose d(ktab) does not fit one block's shared memory (global
    atomics), with K2's budgets on the kernel's own codes, g = 2 rad. At
    64x36x4 d6 (as the gpu test) against its plain version and the float64
    witness, after holding out at most n // HELD_OUT lanes: those whose hit
    points the float64 plain replay puts within rounding of a checker cell
    edge (`checks.edge_lanes`), where each float32 version picks its own
    cell; the count, and K2 against its plain version over all lanes, are
    printed. At full size against its plain version over all lanes, and
    timed."""
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.ops.cuda import _build, checks
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

    lib = _build.load_library()
    for size in (MANY_SMALL, FULL):
        scene, static, cfg, cam = load_scene("many_spheres", size, dev)
        n = cfg.n_rays
        rad, seg, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                          static=static, emit_paths=True)
        o, d, t, rid = integrator._pixel_rays(
            cam, cfg, torch.arange(n, device=dev), cfg.seed)
        ktab = rb.pack_ktab(scene).detach()
        shared = rb.shared_reductions(lib, dev, ktab.shape[1], 0)[0]
        wins = lane_windows(n, PLAIN_CHUNK)

        def k2(g):
            return rb.replay_bwd_fused(ktab, None, scene.background, cfg, o,
                                       d, t, rid, cfg.seed, codes, g, n)

        def k2_plain(g, dtype=None):
            return plain_backward(ktab, None, scene.background, cfg, o, d, t,
                                  rid, cfg.seed, codes, g, wins, dtype=dtype)

        g = 2.0 * rad
        got, ref = k2(g), k2_plain(g)
        stats = dict(d_ktab_all_lanes=norm_rel(got[0], ref[0]),
                     spheres_reached=int((got[0].abs().sum(0) > 0).sum()))
        if size is FULL:
            checked = agree_all(got, ref, check=False)
            stats["plain"] = brief(checked)
            k_ms, p_ms = cuda_ms(lambda: k2(g), 5), cuda_ms(
                lambda: k2_plain(g), 1)
            how = (f"all lanes: {json.dumps(stats)}; replay_bwd_fused "
                   f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, {int(seg.sum())} "
                   f"segments (median; {smi})")
        else:
            edge = checks.edge_lanes(scene, static, cfg, o, d, t, rid, codes,
                                     wins)
            g = g * (~edge).to(g.dtype)[:, None]
            got, ref = k2(g), k2_plain(g)
            checked = (agree_all(got, ref, check=False)
                       + agree_all(got, k2_plain(g, torch.float64),
                                   check=False))
            stats.update(held_out=int(edge.sum()),
                         budget=max(4, n // HELD_OUT),
                         plain=brief(checked[:len(checked) // 2]),
                         float64=brief(checked[len(checked) // 2:]))
            how = f"cell-edge lanes held out: {json.dumps(stats)}"
        print(f"phase 14 K2 vs plain many_spheres ({static.n_spheres} "
              f"spheres, d(ktab) by warp-aggregated global atomics) "
              f"{cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} depth "
              f"{cfg.max_depth}, {how}", flush=True)
        if (shared or stats["spheres_reached"] < 100
                or stats.get("held_out", 0) > max(4, n // HELD_OUT)):
            raise AssertionError(f"many_spheres K2: shared {shared}: {stats}")
        if not all(s_["ok"] for s_ in checked):
            raise AssertionError(f"many_spheres K2 vs plain outside budgets: "
                                 f"{checked}")



# ---- the staged path through a tree: BVH-tri and BVH-sph (phase 15) -------------

# FP32 operations of the BVH kernels, counted from csrc/bvh.cu (a division
# or square root one; the slab test's min, max and compares not counted):
# 12 a node's slab test (6 subtractions, 6 products), 30 a sphere leaf (the
# lerp 8, oc 3, half_b 5, c_term 6, disc 3, the square root and two roots
# 5), 37 a triangle leaf (det 5, 1 / det, ao 3, ao x d 9, u, v, t 6 each,
# u + v). Bytes: a ray's o and d (and time) read and its t and prim
# written; the nodes (32 bytes) and the leaf rows (64 bytes) once.
OPS_BVH_NODE, OPS_BVH_LEAF = 12, {"spheres": 30, "triangles": 37}
BYTES_BVH_RAY = {"spheres": 36, "triangles": 32}
BVH_WINDOW = 1 << 16      # rays a window of the plain traverse on the card
BVH_SPREAD = 1 << 18      # primary rays spread over the frame
PLAIN_SAMPLE = 8          # launches of an entry the plain traverse times,
PLAIN_RAYS = 1 << 22      # and at most about this many rays in all
TREE_SCENES = ("wavefront_cow_obj", "textured_monument",
               "wavefront_suspension_obj", "book2_final_scene")


def spread_rays(scene, static, cfg, cam, n):
    """n primary rays spread over the frame (every k-th lane, k = n_rays //
    n) and the first-bounce rays of those that live (one bounce of the
    staged path on the card) -> two (o, d, time) triples."""
    import dataclasses

    import torch

    from raytracer_weekend_tpu_torch import integrator

    step = max(1, cfg.n_rays // n)
    ids = torch.arange(0, step * n, step, device=scene.device)[:n]
    o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
    with torch.no_grad():
        *_, (o1, d1, _, _, alive, _) = integrator.trace_lanes(
            scene, static, dataclasses.replace(cfg, max_depth=1), o, d, t,
            rid, cfg.seed, return_carry=True)
    return (o, d, t), (o1[alive].contiguous(), d1[alive].contiguous(),
                       t[alive].contiguous())


def tree_of(scene, kind):
    return scene.sphere_bvh if kind == "spheres" else scene.triangle_bvh


def bvh_plain(kind, scene, rays, t_min=1e-3):
    """The plain traverse on the card in windows of BVH_WINDOW rays."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt

    walk = bt.traverse_spheres if kind == "spheres" else bt.traverse_triangles
    n = rays[0].shape[0]
    with torch.no_grad():
        parts = [walk(tree_of(scene, kind), getattr(scene, kind),
                      *(r[w] for r in rays[:3 if kind == "spheres" else 2]),
                      t_min, plain=True)
                 for w in lane_windows(n, BVH_WINDOW)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def bvh_work(kind, tabs, ops_rays, n, t_min=1e-3):
    """(FP32 operations, bytes, the counts) of one BVH launch on these
    operands, from the kernel's counting probe."""
    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt

    counts = bt.count_work(kind, tabs, ops_rays, t_min)
    ops = (OPS_BVH_NODE * counts["nodes visited"]
           + OPS_BVH_LEAF[kind] * counts["leaves tested"])
    nbytes = (n * BYTES_BVH_RAY[kind] + 4 * tabs.nodes.numel()
              + 4 * tabs.rows.numel())
    return ops, nbytes, counts


def brute_launch(kind, table, rays):
    """(K10 or K12's module, its prebuilt table, its ray operands)."""
    from raytracer_weekend_tpu_torch.ops.cuda import (
        sphere_intersect, triangle_intersect)

    if kind == "spheres":
        return (sphere_intersect, sphere_intersect.sphere_table(table),
                sphere_intersect.ray_operands(*rays[:3]))
    return (triangle_intersect, triangle_intersect.triangle_table(table),
            triangle_intersect.ray_operands(*rays[:2]))


def png_pixels(path):
    """(H, W, 3) uint8 of a PNG written by `utils.image.save_png` (8-bit
    RGB, filter 0 on every row): the card's machine may lack Pillow."""
    import struct
    import zlib

    import numpy as np

    data = pathlib.Path(path).read_bytes()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        size, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def run_cli(args, what):
    """`python -m raytracer_weekend_tpu_torch.utils.cli ARGS` from the
    checkout's root in a subprocess -> seconds; raises unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_weekend_tpu_torch.utils.cli",
         *map(str, args)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the CLI exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return time.perf_counter() - t0


def bvh_phase(dev, smi, log):
    """Phase 15: the skip-link trees and the BVH kernels on the card.
    (a) the builder's trees of the cow, the monument, the suspension and
    book2 against the numpy builder; (b) BVH-tri and BVH-sph bit for bit
    the plain traverse on the card on 2^18 primary rays spread over the
    frame and their first-bounce rays, on every tree scene, a 65-triangle
    mesh and jumpy_balls built with bvh=True; each timed on the device
    beside K10/K12 on the same rays; (c)
    the cow's staged frame in one chunk with its tree (BVH-tri) and
    without (K12), against the flip budgets, each launch's device ms; (d)
    the CLI with --resume-dir on the cow at full size in a subprocess, then
    again from the tiles (the same PNG, no tile rewritten); the same
    command in this process with the counts reset; (e) --stream on
    two_spheres decoded by ImageReceiver against stream_render's sums and
    the PNG, and the COBS codec's share of stream_render's time; (f) the CLI's default route on jumpy_balls; book2's staged
    path through utils.debug.check_render_finite (BVH-sph); (g) utils.
    metrics on the card (`front_end_metrics`). Returns the kernels line's
    BVH entries, each timed on the launches of the main-path run that it
    counts (`recorded_launches`)."""
    import shutil

    import numpy as np
    import torch

    from raytracer_weekend_tpu_torch import integrator, native
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti
    from raytracer_weekend_tpu_torch.parallel import stream
    from raytracer_weekend_tpu_torch.scene.builder import build_scene
    from raytracer_weekend_tpu_torch.scene.data import without_trees
    from raytracer_weekend_tpu_torch.utils import cli, debug
    from raytracer_weekend_tpu_torch.utils.image import tone_map

    t_phase = time.perf_counter()
    print(f"phase 15 BVH kernels as compiled: "
          f"{[r for r in ptxas_registers(log) if r.startswith('bvh_')]}",
          flush=True)
    if any("spills" in r for r in ptxas_registers(log)
           if r.startswith("bvh_")):
        raise AssertionError("a BVH kernel spills")

    # ---- 15a. the trees -----------------------------------------------------
    loaded = {}
    for name in TREE_SCENES:
        scene, static, cfg, cam = load_scene(name, FULL, dev)
        loaded[name] = (scene, static, cfg, cam)
        kind = "spheres" if static.sphere_bvh else "triangles"
        tree = tree_of(scene, kind)
        tab = getattr(scene, kind)
        if kind == "spheres":
            c0, c1 = tab.c0.cpu().numpy(), tab.c1.cpu().numpy()
            r = np.abs(tab.radius.cpu().numpy())[:, None]
            lo, hi = np.minimum(c0 - r, c1 - r), np.maximum(c0 + r, c1 + r)
        else:
            v = np.stack([x.cpu().numpy() for x in (tab.v0, tab.v1, tab.v2)],
                         axis=1)
            lo, hi = v.min(axis=1), v.max(axis=1)
            thin = (hi - lo) < 2e-4
            lo, hi = (np.where(thin, lo - 1e-4, lo),
                      np.where(thin, hi + 1e-4, hi))
        cpp = native.build_bvh(lo, hi)
        ref = native._build_bvh_numpy(lo, hi)
        mine = [x.cpu().numpy() for x in tree]
        same_shape = (np.array_equal(cpp[3], ref[3])
                      and np.array_equal(cpp[2] < 0, ref[2] < 0)
                      and sorted(cpp[2][cpp[2] >= 0]) == list(
                          range(lo.shape[0])))
        bitwise = all(np.array_equal(a, b) for a, b in zip(cpp, ref))
        cent = 0.5 * (lo + hi)
        distinct = [len(np.unique(cent[:, a])) for a in range(3)]
        leaves_moved = int((cpp[2] != ref[2]).sum())
        print(f"phase 15a tree {name} ({kind}, {lo.shape[0]} boxes, "
              f"{cpp[2].shape[0]} nodes): the scene's tree is native."
              f"build_bvh's {all(np.array_equal(a, b) for a, b in zip(mine, cpp))}; "
              f"against the numpy builder bit for bit {bitwise}, the same "
              f"shape (skip links, inner nodes, one leaf a box) {same_shape}, "
              f"{leaves_moved} leaves hold another box (distinct centroids "
              f"per axis {distinct}: nth_element and the stable argsort "
              f"split ties apart)", flush=True)
        if not (same_shape and all(np.array_equal(a, b)
                                   for a, b in zip(mine, cpp))):
            raise AssertionError(f"{name}: tree of another shape")
        if min(distinct) == lo.shape[0] and not bitwise:
            raise AssertionError(f"{name}: no tied centroid, yet the trees "
                                 f"differ")

    # ---- 15b. the kernels against the plain traverse; the dispatch readings --
    objs, cams, bg = scenes.mesh_shards(16 / 9)
    g = np.random.default_rng(65)
    mat = objs[-1].material
    objs += [type(objs[-1]).flat_shaded(g.uniform(-2, 2, (3, 3)), mat)
             for _ in range(25)]
    s65, st65 = build_scene(objs, background=bg)
    if not (st65.triangle_bvh and st65.n_triangles == 65):
        raise AssertionError(f"the 65-triangle mesh: {st65}")
    loaded["mesh_65"] = (s65.to(dev), st65, RenderConfig(**FULL),
                         cams[0].to(dev))
    objs, cams, bg = scenes.jumpy_balls(16 / 9)
    sj, stj = build_scene(objs, background=bg, bvh=True)   # 486 spheres
    loaded["jumpy_balls bvh=True"] = (sj.to(dev), stj, RenderConfig(**FULL),
                                      cams[0].to(dev))
    readings, errs = {}, {}
    for name, (scene, static, cfg, cam) in loaded.items():
        kind = "spheres" if static.sphere_bvh else "triangles"
        tree, tab = tree_of(scene, kind), getattr(scene, kind)
        tabs = bt.tables(kind, tree, tab)
        primary, bounce = spread_rays(scene, static, cfg, cam, BVH_SPREAD)
        for which, rays in (("primary", primary), ("first bounce", bounce)):
            n = rays[0].shape[0]
            if not n:      # every hit a light: none bounce
                print(f"phase 15b {name}: no {which} rays", flush=True)
                continue
            ops_r = bt.ray_operands(kind, *rays[:2], rays[2])
            t_k, p_k = bt._launch(kind, tabs, ops_r, cfg.t_min)
            t_p, p_p = bvh_plain(kind, scene, rays, cfg.t_min)
            torch.cuda.synchronize()
            t_off = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
            p_off = int((p_k != p_p).sum())
            hits = int(torch.isfinite(t_k).sum())
            print(f"phase 15b BVH {kind} vs plain traverse {name} {which} "
                  f"rays: {n} rays, {hits} hits, t differs on "
                  f"{t_off} lanes, prim on {p_off} (bit for bit)", flush=True)
            if t_off or p_off or hits < n // 50:
                raise AssertionError(f"BVH {kind} {name} {which}: kernel vs "
                                     f"plain traverse")
            errs[kind] = 0.0
            b_ms, b_ev = launch_times(
                lambda: bt._launch(kind, tabs, ops_r, cfg.t_min))
            mod, table, k_ops = brute_launch(kind, tab, rays)
            k_ms, k_ev = launch_times(
                lambda: mod._launch(table, k_ops, cfg.t_min))
            ops, nbytes, counts = bvh_work(kind, tabs, ops_r, n)
            readings[name, which] = dict(
                kind=kind, rows=tab.valid.shape[0], nodes=tree.prim.shape[0],
                rays=n, bvh_ms=b_ms, brute_ms=k_ms, **counts)
            print(f"phase 15b reading {name} {which} rays: {kind}, "
                  f"{tab.valid.shape[0]} rows, {tree.prim.shape[0]} nodes, "
                  f"{n} rays: BVH {b_ms:.4f} ms on the device ({b_ev:.4f} "
                  f"by events), {json.dumps(counts)}, bound "
                  f"{max(ops / FP32_PEAK, nbytes / HBM_RATE) * 1e3:.4f} ms; "
                  f"{'K10' if kind == 'spheres' else 'K12'} on the same rays "
                  f"{k_ms:.4f} ms ({k_ev:.4f} by events); \"auto\" on the "
                  f"card takes "
                  f"{integrator.hit_routes(scene, static, cfg, dev)[kind]}, "
                  f"the faster here is {'bvh' if b_ms < k_ms else 'kernel'} "
                  f"({smi})", flush=True)
        if integrator.hit_routes(scene, static, cfg, dev)[kind] != "bvh":
            raise AssertionError(f"{name}: a family with a tree does not "
                                 f"take the BVH kernel under \"auto\"")
    print(f"phase 15b readings: "
          f"{json.dumps({' '.join(k): v for k, v in readings.items()})}",
          flush=True)

    # ---- 15c. the cow's staged frame, with its tree and without ----------------
    scene, static, cfg, cam = loaded["wavefront_cow_obj"]
    bare, bare_st = without_trees(scene, static)
    if integrator.hit_routes(scene, static, cfg, dev)["triangles"] != "bvh":
        raise AssertionError("the cow's triangles do not take BVH-tri")
    launches, timed = {}, {}
    bt.TRIANGLE_LAUNCHES = ti.LAUNCHES = 0
    with recorded_launches() as recs:
        rad, seg = staged_frame(scene, static, cfg, cam, cfg.n_rays)
    torch.cuda.synchronize()
    timed["wavefront_cow_obj", cfg.n_rays] = recs
    launches[("triangles", "wavefront_cow_obj", cfg.n_rays)] = \
        bt.TRIANGLE_LAUNCHES
    if bt.TRIANGLE_LAUNCHES != cfg.max_depth or ti.LAUNCHES:
        raise AssertionError(f"the cow's staged frame: BVH-tri "
                             f"{bt.TRIANGLE_LAUNCHES}, K12 {ti.LAUNCHES}")
    k_rad, k_seg = staged_frame(bare, bare_st, cfg, cam, cfg.n_rays)
    ok, stats = _budgets(rad, k_rad, seg.sum(), k_seg.sum(), cfg.n_rays,
                         **PLANAR_BUDGETS)
    tree_ms = cuda_ms(lambda: staged_frame(scene, static, cfg, cam,
                                           cfg.n_rays), 3)
    bare_ms = cuda_ms(lambda: staged_frame(bare, bare_st, cfg, cam,
                                           cfg.n_rays), 3)
    print(f"phase 15c staged frame wavefront_cow_obj {cfg.width}x"
          f"{cfg.height} spp {cfg.samples_per_pixel} depth {cfg.max_depth} "
          f"in one chunk, with its tree (BVH-tri, {launches} launches) "
          f"against without (K12): {json.dumps(stats)}; frame {tree_ms:.3f} "
          f"ms with the tree, {bare_ms:.3f} without, by events ({smi})",
          flush=True)
    if not ok:
        raise AssertionError(f"the cow's staged frame with its tree vs "
                             f"without: {stats}")

    # ---- 15d. the CLI with --resume-dir, in a subprocess, then again ------------
    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    cow_args = ["wavefront_cow_obj", "-w", 400, "-s", 16, "-d", 8,
                "--resume-dir", work / "tiles", "-o", work / "out"]
    first_s = run_cli(cow_args, "cow --resume-dir")
    png = work / "out" / "image_0000.png"
    first = png.read_bytes()
    tiles = sorted((work / "tiles").glob("*.npy"))
    stamps = [p.stat().st_mtime_ns for p in tiles]
    again_s = run_cli(cow_args, "cow --resume-dir, again")
    if (png.read_bytes() != first
            or [p.stat().st_mtime_ns for p in tiles] != stamps
            or sorted((work / "tiles").glob("*.npy")) != tiles):
        raise AssertionError("the resumed CLI run rewrote a tile or wrote "
                             "another PNG")
    img = png_pixels(png)
    if img.shape != (225, 400, 3) or not img.any():
        raise AssertionError(f"the cow's PNG: {img.shape}")
    here = [str(a) for a in cow_args]
    here[here.index(str(work / "tiles"))] = str(work / "tiles_here")
    here[here.index(str(work / "out"))] = str(work / "out_here")
    bt.TRIANGLE_LAUNCHES = 0
    with recorded_launches() as recs:
        if cli.main(here) != 0:
            raise AssertionError("cli.main (cow, --resume-dir) exited "
                                 "non-zero")
    timed["wavefront_cow_obj", 4096 * 16] = recs
    n_tiles = len(tiles)
    launches[("triangles", "wavefront_cow_obj", 4096 * 16)] = \
        bt.TRIANGLE_LAUNCHES
    same = (work / "out_here" / "image_0000.png").read_bytes() == first
    print(f"phase 15d CLI wavefront_cow_obj -w 400 -s 16 -d 8 --resume-dir "
          f"(the staged path through K10, K11 and BVH-tri): {first_s:.1f} s "
          f"in a subprocess, {n_tiles} tiles; again from the tiles "
          f"{again_s:.1f} s, no tile rewritten, the same PNG; in this "
          f"process {bt.TRIANGLE_LAUNCHES} BVH-tri launches, the same PNG "
          f"{same}", flush=True)
    if bt.TRIANGLE_LAUNCHES != n_tiles * 8 or not same:
        raise AssertionError("the CLI in this process")

    # ---- 15e. --stream on two_spheres -------------------------------------------
    sfile = work / "two_spheres.stream"
    run_cli(["two_spheres", "-w", 400, "-s", 16, "-d", 8, "--stream", sfile,
             "-o", work / "stream_out"], "two_spheres --stream")
    rx = stream.ImageReceiver()
    rx.feed(sfile.read_bytes())
    scene2, static2, cfg2, cam2 = load_scene("two_spheres", FULL, dev)
    t0 = time.perf_counter()
    sums = stream.stream_render(scene2, static2, cfg2, cam2, lambda b: None)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    payloads = [stream.cobs_decode(f)
                for f in stream.iter_frames(sfile.read_bytes())]
    t0 = time.perf_counter()
    for p in payloads:
        stream.cobs_encode(p)
    codec_s = time.perf_counter() - t0
    stream_png = png_pixels(work / "stream_out" / "image_0000.png")
    if not (rx.done and rx.errors == 0 and rx.pixels_received == 90000
            and np.array_equal(rx.image, sums)
            and np.array_equal(rx.tone_mapped(), tone_map(sums, 16))
            and np.array_equal(stream_png, rx.tone_mapped())):
        raise AssertionError("two_spheres --stream: the decoded stream is "
                             "not stream_render's sums and the PNG")
    print(f"phase 15e CLI two_spheres --stream: {sfile.stat().st_size} "
          f"bytes, {rx.pixels_received} pixels decoded by ImageReceiver, "
          f"bit for bit stream_render's sums in this process; their tone "
          f"map is the CLI's PNG; stream_render {render_s * 1e3:.1f} ms on "
          f"the host clock, of which the COBS codec on its {len(payloads)} "
          f"frames {codec_s * 1e3:.1f} ms ({codec_s / render_s:.1%}) "
          f"({smi})", flush=True)

    # ---- 15f. the CLI's default route; book2's staged path -----------------------
    j_s = run_cli(["jumpy_balls", "-w", 400, "-s", 16, "-d", 8, "-o",
                   work / "jumpy_out"], "jumpy_balls default route")
    jumpy = png_pixels(work / "jumpy_out" / "image_0000.png")
    scene, static, cfg, cam = loaded["book2_final_scene"]
    bt.SPHERE_LAUNCHES = 0
    with recorded_launches() as recs:
        colors = debug.check_render_finite(scene, static, cfg, cam,
                                           n_lanes=BVH_SPREAD)
    timed["book2_final_scene", BVH_SPREAD] = recs
    launches[("spheres", "book2_final_scene", BVH_SPREAD)] = \
        bt.SPHERE_LAUNCHES
    print(f"phase 15f CLI jumpy_balls (render_image: the megakernel) exit 0 "
          f"in {j_s:.1f} s, PNG {jumpy.shape}; check_render_finite(book2, "
          f"{BVH_SPREAD} lanes) through the staged path: "
          f"{bt.SPHERE_LAUNCHES} BVH-sph launches, {colors.shape[0]} finite "
          f"lanes", flush=True)
    if bt.SPHERE_LAUNCHES != cfg.max_depth or jumpy.shape != (225, 400, 3):
        raise AssertionError("book2's staged path or the jumpy CLI")
    front_end_metrics(loaded["wavefront_cow_obj"], int(seg.sum()), work,
                      dev, smi)

    entries = [bvh_entry(name, n, count, timed[name, n], errs, loaded, smi)
               for (_, name, n), count in sorted(launches.items())]
    print(f"phase 15 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def front_end_metrics(cow, cow_segments, work, dev, smi):
    """Phase 15g: utils.metrics on the card. measured_render of the cow
    (render_image, the megakernel, which reads no tree) counts the
    segments of the kernel's own per-lane counts over the same chunks;
    phase 15c's staged frame through the tree is printed beside it; the
    occupancy of jumpy_balls (the megakernel's codes) and of the uv-debug
    jumpy (the staged segment differences) lie in [0, 1] and fall with
    depth; profiler_trace around one chunk of the cow sees BVH-tri run on
    the device."""
    from torch.autograd import DeviceType

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.utils import metrics

    import numpy as np
    import torch

    scene, static, cfg, cam = cow
    stats = metrics.measured_render(scene, static, cfg, cam)
    n, batch = cfg.n_rays, cfg.ray_batch or cfg.n_rays
    with torch.no_grad():
        fused_segments = sum(
            int(mk.render_fused(scene, cfg, cam, s, min(batch, n - s),
                                cfg.seed, static=static)[1].sum())
            for s in range(0, n, batch))
    occ = {}
    for name in ("jumpy_balls", "jumpy_balls_uvdebug"):
        s2, st2, cfg2, cam2 = load_scene(name, FULL, dev)
        occ[name] = metrics.wavefront_occupancy(s2, st2, cfg2, cam2)
    ids = torch.arange(BVH_SPREAD, device=dev)
    with metrics.profiler_trace(work / "profile") as prof:
        with torch.no_grad():
            integrator.render_chunk(scene, static, cfg, cam, ids, cfg.seed)
    bvh_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and "bvh_kernel" in e.key)
    print(f"phase 15g metrics: measured_render wavefront_cow_obj "
          f"{stats.json_line()} (the kernel's count {fused_segments}, 15c's "
          f"staged frame {cow_segments}); wavefront_occupancy "
          f"{ {k: [round(float(x), 4) for x in v] for k, v in occ.items()} }"
          f"; profiler_trace of one {BVH_SPREAD}-lane chunk of the cow: "
          f"BVH-tri {bvh_us / 1e3:.4f} ms on the device, trace -> "
          f"{(work / 'profile' / 'trace.json').relative_to(ROOT)} ({smi})",
          flush=True)
    bad = [k for k, v in occ.items()
           if v.shape != (8,) or not (0.0 <= v.min() <= v.max() <= 1.0)
           or np.any(np.diff(v) > 1e-6)]
    if (stats.ray_segments != fused_segments or bad or bvh_us <= 0
            or occ["jumpy_balls_uvdebug"][0] != 1.0):
        raise AssertionError(f"metrics on the card: segments "
                             f"{stats.ray_segments} vs {fused_segments}, "
                             f"occupancy {bad}, BVH-tri {bvh_us} us")


def bvh_entry(name, n, launches, recs, errs, loaded, smi):
    """The kernels line's entry of BVH-tri or BVH-sph for the main path's
    launches of n rays on scene `name`, timed on `recs`, the operands of
    those very launches (`recorded_launches`; a ragged last tile has
    fewer): `ms` and `event_ms` the mean of each launch alone on them,
    `wrapper_ms` the Function's call on the same rays less `event_ms`,
    `plain_ms` the plain traverse (windows of BVH_WINDOW) on at most
    PLAIN_SAMPLE of them (and about PLAIN_RAYS rays) spread over the run,
    the bound from the kernel's own counts on every one. K10/K12's brute force
    is timed on the same launches beside it."""
    import torch

    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt

    scene = loaded[name][0]
    kind = recs[0][0]
    if len(recs) != launches or any(r[2][0].shape[0] > n for r in recs):
        raise AssertionError(f"{name}: {len(recs)} recorded launches for "
                             f"{launches} counted, or more than {n} rays")
    walk = bt.traverse_spheres if kind == "spheres" else bt.traverse_triangles
    before = bt.SPHERE_LAUNCHES, bt.TRIANGLE_LAUNCHES
    times, f_ms, k_ms, plain, ops, nbytes = [], 0.0, 0.0, [], 0, 0
    counts = {}
    n_plain = min(len(recs), PLAIN_SAMPLE, max(1, PLAIN_RAYS // n))
    sample = set(range(0, len(recs), -(-len(recs) // n_plain)))
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    for i, (_, tabs, ops_r, t_min) in enumerate(recs):
        times.append(launch_times(lambda: bt._launch(kind, tabs, ops_r,
                                                     t_min)))
        f_ms += cuda_ms(lambda: walk(tree_of(scene, kind),
                                     getattr(scene, kind), *ops_r, t_min,
                                     tables=tabs))
        mod, table, k_ops = brute_launch(kind, getattr(scene, kind), ops_r)
        k_ms += device_ms(lambda: mod._launch(table, k_ops, t_min), 5)
        if i in sample:
            plain.append(cuda_ms(lambda: bvh_plain(kind, scene, ops_r,
                                                   t_min), 1))
        o_i, b_i, c_i = bvh_work(kind, tabs, ops_r, ops_r[0].shape[0],
                                 t_min)
        ops, nbytes = ops + o_i, nbytes + b_i
        counts = {k: counts.get(k, 0) + v for k, v in c_i.items()}
    torch.set_grad_enabled(grad)
    bt.SPHERE_LAUNCHES, bt.TRIANGLE_LAUNCHES = before
    torch.cuda.synchronize()
    m = len(recs)
    l_ms = sum(t[0] for t in times) / m
    l_ev = sum(t[1] for t in times) / m
    p_ms = sum(plain) / len(plain)
    short = "BVH-sph" if kind == "spheres" else "BVH-tri"
    spread = ([round(t[0], 4) for t in times] if m <= PLAIN_SAMPLE
              else [round(min(t[0] for t in times), 4),
                    round(max(t[0] for t in times), 4)])
    print(f"phase 15 timing {short} {name}: {m} launches of up to {n} "
          f"rays as the main path made them, {recs[0][1].nodes.shape[0]} nodes: "
          f"launch {l_ms:.4f} ms on the device a launch (mean; "
          f"{'each' if m <= PLAIN_SAMPLE else 'min, max'} {spread}), "
          f"{l_ev:.4f} by events, Function call {f_ms / m:.4f} ms, plain "
          f"traverse {p_ms:.3f} ms (mean of {len(plain)}); "
          f"{'K10' if kind == 'spheres' else 'K12'} on the same launches "
          f"{k_ms / m:.4f} ms on the device; {json.dumps(counts)} in all, "
          f"{ops / m:.4e} FP32 operations and {nbytes // m} bytes a launch "
          f"({smi})", flush=True)
    return bound({
        "name": f"{short}[{name} {n} rays]",
        "route": "cuda",
        "source": "raytracer_weekend_tpu_torch/csrc/bvh.cu",
        # No TPU kernel: the JAX function it replaces, a jnp while_loop.
        "replaces": "raytracer_weekend_tpu/ops/bvh.py:43",
        "launches": launches,
        "max_abs_err": errs[kind],
        "ms": l_ms,
        "event_ms": l_ev,
        "wrapper_ms": f_ms / m - l_ev,
        "plain_ms": p_ms,
    }, ops / m, nbytes / m)


# ---- phase 16: the render mesh ------------------------------------------------

MESH_MONUMENT = dict(width=1920, height=1080, samples_per_pixel=4,
                     max_depth=8, ray_batch=1 << 20)
MESH_JUMPY = dict(width=400, height=225, samples_per_pixel=16, max_depth=8)
MESH_TIMEOUT_S = 420
# The kernel launch counters of the port's wrappers, (module, counter).
MESH_COUNTERS = (
    ("megakernel", "LAUNCHES"), ("megakernel", "EMIT_LAUNCHES"),
    ("megakernel", "DEFER_LAUNCHES"), ("megakernel", "PHASE_LAUNCHES"),
    ("replay_bwd", "LAUNCHES"), ("replay_bwd", "DEFER_LAUNCHES"),
    ("sphere_intersect", "LAUNCHES"), ("rect_intersect", "LAUNCHES"),
    ("triangle_intersect", "LAUNCHES"), ("bvh_traverse", "SPHERE_LAUNCHES"),
    ("bvh_traverse", "TRIANGLE_LAUNCHES"))


def kernel_launches(raw, static):
    """The counters' readings by kernel name (the kernels line's names):
    a forward launch is K1 on a sphere scene, K3 with planar rows, K5 with
    media (K3 wins where both), K1-emit/K3-emit/K5-emit with codes; the
    replay backward K2, or K4 with planar rows; K6a, K6b, K7 as counted."""
    planar = static.n_rects + static.n_triangles > 0
    fwd = "K3" if planar else ("K5" if static.n_volumes else "K1")
    names = {
        "megakernel.LAUNCHES": fwd, "megakernel.EMIT_LAUNCHES": fwd + "-emit",
        "megakernel.DEFER_LAUNCHES": "K6a",
        "megakernel.PHASE_LAUNCHES": "K6b",
        "replay_bwd.LAUNCHES": "K4" if planar else "K2",
        "replay_bwd.DEFER_LAUNCHES": "K7",
        "sphere_intersect.LAUNCHES": "K10", "rect_intersect.LAUNCHES": "K11",
        "triangle_intersect.LAUNCHES": "K12",
        "bvh_traverse.SPHERE_LAUNCHES": "BVH-sph",
        "bvh_traverse.TRIANGLE_LAUNCHES": "BVH-tri"}
    return {names[k]: n for k, n in raw.items() if k in names and n}


@contextlib.contextmanager
def counted_launches():
    """Every kernel counter set to 0 on entry; yields a dict filled on exit
    with the counters' readings ("module.COUNTER": launches made inside)."""
    import importlib

    mods = {m: importlib.import_module(
        f"raytracer_weekend_tpu_torch.ops.cuda.{m}") for m, _ in MESH_COUNTERS}
    got = {}
    for m, attr in MESH_COUNTERS:
        setattr(mods[m], attr, 0)
    try:
        yield got
    finally:
        for m, attr in MESH_COUNTERS:
            got[f"{m}.{attr}"] = getattr(mods[m], attr)


@contextlib.contextmanager
def timed_collectives():
    """Host ms of every torch.distributed.all_reduce made inside, each
    between two synchronizations of the card (so the reading holds the
    collective alone), summed into the yielded list's one entry."""
    import torch
    import torch.distributed as dist

    reduce, spent = dist.all_reduce, [0.0]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += (time.perf_counter() - t0) * 1e3
        return out

    dist.all_reduce = timed
    try:
        yield spent
    finally:
        dist.all_reduce = reduce


def _mesh_scene(name, dev):
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models.scenes import generate_scene

    cfg = RenderConfig(**(MESH_MONUMENT if name == "textured_monument"
                          else MESH_JUMPY))
    scene, static, cams = generate_scene(name, cfg.aspect_ratio, seed=0,
                                         device=dev)
    return scene, static, cfg, cams[0]


def staged_frame_sums(scene, static, cfg, cam):
    """The single-device staged frame in cfg.ray_batch chunks -> ((H, W, 3)
    sums, segments)."""
    import torch

    from raytracer_weekend_tpu_torch import integrator

    n, batch = cfg.n_rays, cfg.ray_batch or cfg.n_rays
    lanes, segs = [], 0
    with torch.no_grad():
        for start in range(0, n, batch):
            ids = torch.arange(start, min(n, start + batch),
                               device=scene.device)
            c, k = integrator.render_chunk(scene, static, cfg, cam, ids,
                                           cfg.seed, return_stats=True)
            lanes.append(c)
            segs += int(k)
    sums = torch.cat(lanes).reshape(cfg.n_pixels, cfg.samples_per_pixel,
                                    3).sum(dim=1)
    return sums.reshape(cfg.height, cfg.width, 3), segs


def _pixel_flips(got, ref, got_seg, ref_seg):
    """tests/test_torch_bvh.py's staged budget on a frame's pixels: (|dseg|,
    pixels off by more than 5% relative, mean abs error, the budget)."""
    import torch

    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    bad = int((rel > 0.05).any(dim=-1).sum())
    n = ref.shape[0] * ref.shape[1]
    return (abs(got_seg - ref_seg), bad,
            float((got - ref).abs().mean()), max(2, n // 500))


def _rank_case(case, rank, out):
    """One rank's part of a phase-16 world (see mesh_phase): drives the
    case's main path with the launch counts reset just before, checks it
    against the single-device reference the parent saved, times it, and
    writes what it saw to out/{case}_{rank}.json. Any failure raises."""
    import torch
    import torch.distributed as dist

    from raytracer_weekend_tpu_torch import integrator, train
    from raytracer_weekend_tpu_torch.parallel import mesh, shard
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    shape = {"jumpy_4": (4, 1, 1), "jumpy_2": (2, 1, 1),
             "jumpy_spp": (1, 2, 1), "jumpy_nccl": (1, 1, 1),
             "train_2": (2, 1, 1), "monument_2": (2, 1, 1),
             "monument_geom": (1, 1, 2)}[case]
    rmesh = mesh.make_render_mesh(shape)
    scene_name = ("textured_monument" if case.startswith("monument")
                  else "jumpy_balls")
    scene, static, cfg, cam = _mesh_scene(scene_name, rmesh.device)
    ref = torch.load(out / f"{case.split('_')[0]}_ref.pt",
                     map_location=rmesh.device)
    fused = (rmesh.n_spp == rmesh.n_geom == 1
             and integrator.fused_eligible(static, cfg, rmesh.device))
    local = shard.shard_scene(scene, rmesh.n_geom, rmesh.coord[2])
    if rmesh.n_geom > 1:
        # make_shard_body builds this rank's trees anew on every call.
        tree_ms = host_ms(lambda: shard.shard_scene(
            scene, rmesh.n_geom, rmesh.coord[2]), 3)
    seen = {"case": case, "rank": rank, "shape": list(shape),
            "coord": list(rmesh.coord), "backend": dist.get_backend(),
            "device": str(rmesh.device),
            "route": "fused" if fused else
            f"staged {integrator.hit_routes(local, static, cfg, rmesh.device)}"}
    if rmesh.n_geom > 1:
        seen["tree_build_ms"] = tree_ms

    if case == "train_2":
        start = SceneData.from_leaves(ref["start"], ref["trees"])
        target = ref["target"]
        ir = train.InverseRenderer(static, cfg, cam, target, rmesh=rmesh)
        ir.value_and_grad(start)                       # warm-up
        with counted_launches() as raw:
            loss, grads = ir.value_and_grad(start)
        launches = kernel_launches(raw, static)
        torch.cuda.synchronize()
        top = max(float(g.norm()) for g in ref["grads"])
        rel = [float((g - r).norm()) / (float(r.norm()) or top)
               for g, r in zip(grads, ref["grads"])]
        seen.update(launches=launches, loss=loss, ref_loss=ref["loss"],
                    worst_norm_rel=max(rel))
        if not (max(rel) <= 1e-4 and abs(loss - ref["loss"])
                <= 1e-4 * abs(ref["loss"])):
            raise AssertionError(f"rank {rank}: sharded step off the "
                                 f"single-device step: {seen}")
        ms = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ir.value_and_grad(start)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        seen["step_ms"] = ms
    else:
        def frame():
            with torch.no_grad():
                return shard.render_sharded(scene, static, cfg, cam, rmesh,
                                            return_segments=True)

        frame()                                        # warm-up
        with counted_launches() as raw:
            img, segs = frame()
        launches = kernel_launches(raw, static)
        torch.cuda.synchronize()
        seen.update(launches=launches, segments=int(segs))
        staged = not fused
        want = ref["staged" if staged else "sums"]
        if case == "monument_geom":
            dseg, bad, mean, budget = _pixel_flips(img, want, int(segs),
                                                   ref["staged_segments"])
            seen.update(check="staged budget", dseg=dseg, bad_pixels=bad,
                        mean_abs=mean, budget=budget)
            ok = dseg <= budget and bad <= budget and mean < 1e-4
        elif case == "jumpy_spp":
            # The spp axis takes the staged path (as JAX's shard body does):
            # held to the single-device staged frame, the order of the spp
            # sum apart.
            err = float((img - want).abs().max())
            seen.update(check="2e-5 of the staged frame", max_abs_err=err)
            ok = (torch.allclose(img, want, rtol=2e-5, atol=2e-5)
                  and int(segs) == ref["staged_segments"])
        else:
            seen.update(check="bitwise")
            ok = torch.equal(img, want) and int(segs) == ref["segments"]
        if not ok:
            raise AssertionError(f"rank {rank}: sharded frame off the "
                                 f"single-device frame: {seen}")
        ms = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        seen["frame_ms"] = ms
        if case == "jumpy_nccl":
            one = torch.ones(1, device=rmesh.device)
            dist.all_reduce(one)
            seen["nccl_all_reduce"] = float(one)
    with timed_collectives() as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if case == "train_2":
            ir.value_and_grad(start)
        else:
            frame()
        torch.cuda.synchronize()
    seen.update(instrumented_ms=(time.perf_counter() - t0) * 1e3,
                collective_ms=spent[0])
    missing = [k for k in EXPECTED_LAUNCHES[case]
               if not seen["launches"].get(k)]
    if missing:
        raise AssertionError(f"rank {rank} of {case}: no launch of "
                             f"{missing} on the main path: {seen}")
    (out / f"{case}_{rank}.json").write_text(json.dumps(seen))


# The kernels each world's main path must launch in every rank.
EXPECTED_LAUNCHES = {
    "jumpy_4": ("K1",), "jumpy_2": ("K1",), "jumpy_spp": ("K10",),
    "jumpy_nccl": ("K1",), "train_2": ("K1-emit", "K2"),
    "monument_2": ("K3",), "monument_geom": ("BVH-tri",)}


def _rank_main(case, rank, size, out, store):
    """Entry of a spawned rank: one card shared by every rank of the world
    (LOCAL_RANK % 1 = 0), LOCAL_WORLD_SIZE = the world's size, so that
    `distributed_init` takes gloo for a world of several ranks and nccl for
    a world of one."""
    import os

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(size)
    import torch

    from raytracer_weekend_tpu_torch.parallel import mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.distributed_init(init_method=f"file://{store}", rank=rank,
                          world_size=size, timeout_s=300)
    try:
        _rank_case(case, rank, pathlib.Path(out))
    finally:
        mesh.dist.destroy_process_group()


def run_world(case, size, out):
    """Spawn `size` ranks of `case` on the card and wait for them; a rank
    that fails, or a world past MESH_TIMEOUT_S, fails the phase (every rank
    is stopped first)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = out / f"store_{case}"
    store.unlink(missing_ok=True)
    procs = [ctx.Process(target=_rank_main,
                         args=(case, r, size, str(out), str(store)))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.time() + MESH_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs
                      if p.exitcode not in (None, 0)]
            if failed or time.time() > deadline:
                raise AssertionError(
                    f"phase 16 {case}: rank exit codes "
                    f"{[p.exitcode for p in procs]}"
                    + (" (timed out)" if not failed else ""))
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"phase 16 {case}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [json.loads((out / f"{case}_{r}.json").read_text())
            for r in range(size)]


def mesh_phase(smi):
    """Phase 16: the render mesh (parallel/mesh, shard) on the one card,
    ranks spawned per world with torch.multiprocessing over gloo (nccl for
    the world of one rank). The parent renders the single-device
    references: jumpy_balls 400x225x16 d8 (render_image: K1) and its train
    gradient (InverseRenderer.value_and_grad from color1 + 0.2: K1-emit,
    K2), the textured monument at 1920x1080x4 d8 through render_image (K3)
    and through the staged path (BVH-tri). Then: jumpy on (4,1,1) and
    (2,1,1) bitwise, on (1,2,1) within 2e-5 (the staged path, K10); the
    train step's loss and gradient on (2,1,1) within 1e-4 norm-relative of
    the single-device step; the monument on (2,1,1) bitwise and on (1,1,2)
    (per-shard trees) within the staged budget; jumpy on an nccl world of
    one rank, bitwise. Each rank prints its backend, route, launches
    (counts reset just before the main path), frame ms and the collectives'
    ms (an instrumented frame, each all_reduce between syncs); a geometry
    rank also the ms of building its slice's trees. Every frame and step
    time, single-device and sharded, is read by the host's clock between
    synchronizations of the card, median of 3."""
    import statistics

    import torch

    from raytracer_weekend_tpu_torch import integrator, train
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

    dev = torch.device("cuda", 0)
    out = ROOT / "build" / "phase16"
    out.mkdir(parents=True, exist_ok=True)
    single = {}
    for name, key in (("jumpy_balls", "jumpy"),
                      ("textured_monument", "monument")):
        scene, static, cfg, cam = _mesh_scene(name, dev)
        batch = cfg.ray_batch or cfg.n_rays
        with torch.no_grad():
            sums = integrator.render_image(scene, static, cfg, cam)
            segs = sum(int(mk.render_fused(
                scene, cfg, cam, start, min(batch, cfg.n_rays - start),
                cfg.seed, static=static)[1].sum(dtype=torch.int64))
                for start in range(0, cfg.n_rays, batch))
        staged, staged_segs = staged_frame_sums(scene, static, cfg, cam)
        torch.save({"sums": sums, "segments": segs, "staged": staged,
                    "staged_segments": staged_segs}, out / f"{key}_ref.pt")
        single[key] = host_ms(lambda: integrator.render_image(
            scene, static, cfg, cam), 3)
        single[key + " staged"] = host_ms(lambda: staged_frame_sums(
            scene, static, cfg, cam), 3)
        print(f"phase 16 single device {name} {cfg.width}x{cfg.height} spp "
              f"{cfg.samples_per_pixel} depth {cfg.max_depth} (host clock, "
              f"median of 3): render_image "
              f"{single[key]:.3f} ms, {segs} segments; the staged frame "
              f"{single[key + ' staged']:.3f} ms, {staged_segs} segments "
              f"({smi})", flush=True)
        if key == "jumpy":
            target, start = fit_inputs(scene, static, cfg, cam)
            ir = train.InverseRenderer(static, cfg, cam, target)
            loss, grads = ir.value_and_grad(start)
            single["train"] = host_ms(lambda: ir.value_and_grad(start), 3)
            torch.save({"start": start.leaves(), "trees": start.trees,
                        "target": target, "loss": loss, "grads": grads},
                       out / "train_ref.pt")
            print(f"phase 16 single device jumpy_balls train step "
                  f"(InverseRenderer.value_and_grad): loss {loss:.6e}, "
                  f"{single['train']:.3f} ms (host clock) ({smi})",
                  flush=True)
            del ir, grads, target, start
    del scene, sums, staged
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for case, size, base in (("jumpy_4", 4, "jumpy"), ("jumpy_2", 2, "jumpy"),
                             ("jumpy_spp", 2, "jumpy staged"),
                             ("train_2", 2, "train"),
                             ("monument_2", 2, "monument"),
                             ("monument_geom", 2, "monument staged"),
                             ("jumpy_nccl", 1, "jumpy")):
        t0 = time.perf_counter()
        ranks = run_world(case, size, out)
        for seen in ranks:
            times = seen.get("frame_ms") or seen.get("step_ms")
            extra = {k: seen[k] for k in (
                "check", "dseg", "bad_pixels", "mean_abs", "budget",
                "max_abs_err", "worst_norm_rel", "loss", "ref_loss",
                "nccl_all_reduce", "tree_build_ms") if k in seen}
            print(f"phase 16 {case} rank {seen['rank']} {seen['coord']} of "
                  f"{seen['shape']}: backend {seen['backend']}, "
                  f"{seen['device']}, route {seen['route']}; launches "
                  f"{json.dumps(seen['launches'])}; "
                  f"{'step' if case == 'train_2' else 'frame'} ms median "
                  f"{statistics.median(times):.3f} by the host clock "
                  f"(single device {single[base]:.3f}); instrumented "
                  f"{seen['instrumented_ms']:.3f} ms of which all_reduce "
                  f"{seen['collective_ms']:.3f} "
                  f"({seen['collective_ms'] / seen['instrumented_ms']:.1%});"
                  f" {json.dumps(extra)} ({smi})", flush=True)
        print(f"phase 16 {case}: {size} ranks passed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)



# ---- the image-only combine pair (phase 17) ---------------------------------

# earth.fit16's step (rtbench's `earth` configuration, `fit16` traffic):
# 400x225, 16 spp, depth 50.
EARTH_FIT = dict(width=400, height=225, samples_per_pixel=16, max_depth=50,
                 seed=11)
# csrc/combine.cu's FP32 operations: a record's product and sum 6 (the VJP's
# g_k 3); a live record's UV and fetch ~40 and its factor 3 (the VJP's
# second walk: the suffix 6 a record spanned, the texel's gradient 3).
OPS_COMBINE_RECORD, OPS_COMBINE_LIVE = 6, 43


def image_combine_phase(dev, smi):
    """Phase 17: the image-only combine pair (csrc/combine.cu) on
    earth.fit16's records: the forward kernel bitwise the torch loop of
    `combine_deferred`, the VJP kernel's g_k bitwise its torch autograd and
    its texel gradient within 1e-5 relative L1; each launch alone, the
    wrappers, the plain versions and the torch path they replace timed;
    then InverseRenderer.fit for 3 Adam steps on that frame with the pair's
    launch counts reset just before. Returns the kernels line's two
    entries."""
    import torch

    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.ops.cuda import image_combine as ic
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from rtbench import common, port
    from rtbench.reference import scenes as RS

    conf = common.load_json(common.ROOT / "configs" / "earth.json")
    scene, static, cam = port.build(RS.make_scene(conf), dev)
    cfg = RenderConfig(**EARTH_FIT)
    if static.has_noise or static.defer_single_hit:
        raise AssertionError(f"earth is not an image-only general combine: "
                             f"{static}")
    tex = scene.textures
    _, _, _, ctb, abc, dcode = mk.render_fused_records(
        scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static,
        emit_paths=True)
    n, D = dcode.shape
    live = int((dcode != 0).sum())
    g = torch.randn((n, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(17))

    def torch_forward():
        return mk.combine_deferred(tex, ctb, abc, dcode, has_noise=False,
                                   has_image=True)

    def torch_vjp():
        images = tex.images.detach().clone().requires_grad_()
        c = ctb.detach().clone().requires_grad_()
        rad = mk.combine_deferred(
            tex._replace(images=images), c,
            torch.where((dcode != 0)[..., None], abc, 0.5), dcode,
            has_noise=False, has_image=True)
        return torch.autograd.grad(rad, [c, images], g)

    got = ic.combine_images(tex, ctb, abc, dcode)
    want = torch_forward()
    g_k, d_img = ic.combine_images_vjp(tex, ctb, abc, dcode, g)
    want_gk, want_img = torch_vjp()
    plain_gk, plain_img = ic.combine_images_vjp_reference(tex, ctb, abc,
                                                          dcode, g)
    torch.cuda.synchronize()
    stats = dict(
        lanes=n, depth=D, live_records=live,
        rad_bitwise=bool(torch.equal(got, want)),
        g_k_bitwise_autograd=bool(torch.equal(g_k, want_gk)),
        g_k_bitwise_plain=bool(torch.equal(g_k, plain_gk)),
        texel_rel_l1_autograd=float((d_img - want_img).abs().sum()
                                    / want_img.abs().sum()),
        texel_rel_l1_plain=float((d_img - plain_img).abs().sum()
                                 / plain_img.abs().sum()))
    print(f"phase 17 the image combine pair vs torch on earth.fit16's "
          f"records ({cfg.width}x{cfg.height} spp {cfg.samples_per_pixel} "
          f"depth {D}): {json.dumps(stats)}", flush=True)
    if not (stats["rad_bitwise"] and stats["g_k_bitwise_autograd"]
            and stats["g_k_bitwise_plain"]
            and stats["texel_rel_l1_autograd"] < 1e-5
            and stats["texel_rel_l1_plain"] < 1e-5):
        raise AssertionError(f"the image combine pair vs torch: {stats}")
    vjp_err = float(max((g_k - plain_gk).abs().max(),
                        (d_img - plain_img).abs().max()))
    del want_gk, want_img, plain_gk, plain_img

    ops = ic.operands(tex, ctb, abc, dcode)
    fwd_ms, fwd_ev = launch_times(lambda: ic._launch_combine(ops))
    vjp_ms, vjp_ev = launch_times(lambda: ic._launch_vjp(ops, g))
    fwd_call = cuda_ms(lambda: ic.combine_images(tex, ctb, abc, dcode))
    vjp_call = cuda_ms(lambda: ic.combine_images_vjp(tex, ctb, abc, dcode,
                                                     g))
    torch_fwd_ms = cuda_ms(torch_forward, 3)
    torch_vjp_ms = cuda_ms(torch_vjp, 3)
    plain_vjp_ms = cuda_ms(lambda: ic.combine_images_vjp_reference(
        tex, ctb, abc, dcode, g), 3)
    rows, texels = n * D * 32, live * 12
    fwd_work = (n * D * OPS_COMBINE_RECORD + live * OPS_COMBINE_LIVE,
                rows + texels + n * 12)
    vjp_work = (n * D * OPS_COMBINE_RECORD + live * 2 * OPS_COMBINE_LIVE,
                rows + texels + n * 12 + n * D * 12
                + tex.images.numel() * 4)
    print(f"phase 17 timing on {smi}: the forward kernel alone "
          f"{fwd_ms:.4f} ms ({fwd_ev:.4f} by events), its call "
          f"{fwd_call:.4f}; the VJP kernel alone {vjp_ms:.4f} ms "
          f"({vjp_ev:.4f}), its call {vjp_call:.4f}; the torch combine "
          f"they replace: forward {torch_fwd_ms:.3f} ms, under autograd "
          f"with its scatter {torch_vjp_ms:.3f} ms; the plain VJP on the "
          f"card {plain_vjp_ms:.3f} ms; bytes {fwd_work[1]} / "
          f"{vjp_work[1]}", flush=True)

    target = torch.full((cfg.height, cfg.width, 3), 0.4, device=dev)
    start = scene._replace(textures=tex._replace(
        images=torch.full_like(tex.images, 0.5)))
    ic.COMBINE_LAUNCHES = ic.COMBINE_VJP_LAUNCHES = 0
    hist, step_ms = fit_three_steps(static, cfg, cam, target, start,
                                    falling=False)
    counts = (ic.COMBINE_LAUNCHES, ic.COMBINE_VJP_LAUNCHES)
    if counts != (3, 3):
        raise AssertionError(f"earth.fit16's fit: the pair's launches "
                             f"{counts}, not one each a step")
    print(f"phase 17 training path: InverseRenderer.fit earth.fit16's frame,"
          f" 3 Adam steps from texels 0.5 on {smi}: {counts[0]} forward and "
          f"{counts[1]} VJP launches; loss "
          f"{' -> '.join(f'{v:.6e}' for v in hist)}; step ms "
          f"{', '.join(f'{v:.3f}' for v in step_ms)}", flush=True)
    source = "raytracer_weekend_tpu_torch/csrc/combine.cu"
    return [bound({
        "name": "image_combine_forward", "route": "cuda", "source": source,
        "replaces": None, "launches": counts[0],
        "max_abs_err": float((got - want).abs().max()),
        "ms": fwd_ms, "event_ms": fwd_ev, "wrapper_ms": fwd_call - fwd_ev,
        "plain_ms": torch_fwd_ms,
    }, *fwd_work), bound({
        "name": "image_combine_vjp", "route": "cuda", "source": source,
        "replaces": None, "launches": counts[1],
        "max_abs_err": vjp_err,
        "ms": vjp_ms, "event_ms": vjp_ev, "wrapper_ms": vjp_call - vjp_ev,
        "plain_ms": plain_vjp_ms,
    }, *vjp_work)]


def image_combine_alone():
    """Phase 17 by itself, with the card's line and the kernels line:
    python3 -c 'import chip_smoke; chip_smoke.image_combine_alone()'."""
    import torch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} | cuda {torch.version.cuda}",
          flush=True)
    print(json.dumps({"kernels": image_combine_phase(dev, smi)}))



@contextlib.contextmanager
def recorded_launches():
    """Records (kind, tables, ray operands, t_min) of every BVH launch made
    inside, as the path made it; the launches and their counts are
    unchanged (the counting probe is not recorded)."""
    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt

    launch, recs = bt._launch, []

    def record(kind, tabs, rays, t_min, counts=None):
        if counts is None:
            recs.append((kind, tabs, tuple(rays), t_min))
        return launch(kind, tabs, rays, t_min, counts)

    bt._launch = record
    try:
        yield recs
    finally:
        bt._launch = launch


if __name__ == "__main__":
    main()
