"""The media kernel (`media_kernel` in csrc/megakernel.cuh: K5, K5-emit
and K6a's records on scenes with media, and K6b's phased launches with
media at one lane a ray) through what the CPU can hold of it (the card runs
the kernel itself: `chip_smoke.py` phases 11 to 13,
`tests/test_torch_cuda.py`, `utils/ab_render.py`).

  * The route rule (`megakernel.fused_kernel`, a pure function of the
    scene's counts and a phased launch's lanes a ray): the single pass of
    smokey_cornell_box, sphere_medium and book2_final_scene and their
    phased launches at G = 1 take the media kernel, their phased launches
    at G > 1 stay on render_kernel, and the scenes without media keep
    theirs; the tables `build_tables` gives the media kernel are the ones
    it reads.
  * The module's mirrored compile-time constants and the C dispatch are
    the kernel's.
  * Its work order (`claim_order` with one lane slot a thread, as
    `media_kernel` runs) runs each lane of a ragged window exactly once,
    and the lanes rendered slot by slot in that order and put back at
    their own indices are the one-lane-a-thread render bit for bit, codes
    and records included; in the phased launches of a depth-50 frame, each
    lane's bounces capped at the phase's length, the same holds phase by
    phase for radiance, segments, records and state.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models import scenes
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.scene.builder import build_scene

CUH = (Path(__file__).resolve().parents[1] / "raytracer_weekend_tpu_torch"
       / "csrc" / "megakernel.cuh")
SMALL = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6,
                     seed=3)


def _scene(name, cfg=SMALL):
    if name in scenes.SCENES:
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device="cpu")
    else:
        objs, cams, bg = getattr(scenes, name)(cfg.aspect_ratio)
        scene, static = build_scene(objs, background=bg)
    return scene, static, cams[0]


@pytest.mark.parametrize("name, counts", [
    ("smokey_cornell_box", (0, 6, 2)),
    ("sphere_medium", (1, 2, 1)),
    ("book2_final_scene", (1006, 2401, 2)),
])
def test_route_rule(name, counts):
    scene, static, cam = _scene(name)
    S, R, V = counts
    assert (static.n_spheres, static.n_rects + static.n_triangles,
            static.n_volumes) == counts
    assert mk.fused_kernel(R, V, phase=False) == "media_kernel"
    # A phased launch refills at one lane a ray; its groups keep the walk.
    assert mk.fused_kernel(R, V, phase=True, group=1) == "media_kernel"
    for g in mk.GROUPS[1:]:
        assert mk.fused_kernel(R, V, phase=True, group=g) == "render_kernel"
    # The same scene without its media: its planar rows keep render_kernel,
    # phased too.
    assert mk.fused_kernel(R, 0, phase=False) == "render_kernel"
    assert mk.fused_kernel(R, 0, phase=True, group=1) == "render_kernel"
    assert mk.fused_kernel(0, 0, phase=False) == "sphere_kernel"
    assert mk.fused_kernel(0, 0, phase=True, group=1) == "render_kernel"
    assert mk.fused_kernel(0, V, phase=False) == "media_kernel"
    assert mk.fused_kernel(0, V, phase=True, group=1) == "media_kernel"
    assert mk.fused_kernel(0, V, phase=True, group=2) == "render_kernel"
    # A phased launch's kernel depends on its group, so it states one.
    with pytest.raises(ValueError):
        mk.fused_kernel(R, V, phase=True)
    # What the media kernel reads: the volume table, the packed sphere rows
    # (none without spheres) and the packed planar rows.
    tab, ptab, ptest, vtab, par, srows = mk.build_tables(scene, static, cam)
    assert vtab.shape == (V, len(mk.VOL_COLS))
    assert ptest.numel() == 16 * R
    if S:
        assert torch.equal(srows, mk.build_sphere_rows(tab))
    else:
        assert srows is None


def test_mirrored_constants_are_the_kernels():
    src = CUH.read_text()
    block = re.search(r"constexpr int kMediaBlock = (\d+);", src)
    assert block and int(block.group(1)) == mk.MEDIA_BLOCK
    # The C dispatch takes media_kernel for every single pass with media
    # and every phased launch that the caller sends there with `refill`,
    # which it takes only with media at one lane a ray, as fused_kernel
    # says; the other phased launches with media take render_kernel's.
    cu = (CUH.parent / "megakernel.cu").read_text()
    assert ("if (vol && (!phase || refill)) {\n    const MediaTables T"
            in cu)
    assert ("if (refill != 0 && (refill != 1 || !vol || !phase || group != "
            "1))\n    return (int)cudaErrorInvalidValue;\n"
            "  const bool media = vol && (!phase || refill);" in cu)
    assert ('static_assert(!kVol || kPhase,\n'
            '                "the single pass with media is media_kernel\'s")'
            in src)
    for e, d, ph in ((0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1),
                     (0, 1, 1)):
        flags = ", ".join("true" if f else "false" for f in (e, d, ph))
        assert f"RTW_MEDIA_LAUNCHER(PREFIX, {flags})" in src
    vcols = re.search(r"enum VCol \{(.*?)N_VCOLS", src, re.S).group(1)
    assert len(re.findall(r"V_[A-Z0-9]+", vcols)) == len(mk.VOL_COLS)


@pytest.mark.parametrize("name", ["smokey_cornell_box", "sphere_medium"])
@pytest.mark.parametrize("lane_start, n, warps", [
    (0, 5, 3),        # a window smaller than one warp
    (0, 1037, 4),     # not a multiple of the block; slots refilled
    (300, 1037, 40),  # lane_start > 0; more slots than lanes
])
def test_work_order_runs_each_lane_once(name, lane_start, n, warps):
    scene, static, cam = _scene(name)
    cfg = SMALL
    ref = mk.records_reference(scene, cfg, cam, lane_start, n, cfg.seed,
                               static=static, emit_paths=True)
    seg = ref[1]
    order, owner = mk.claim_order(seg, warps, rays=1, seed=n)
    assert torch.equal(order.sort().values, torch.arange(n))
    assert bool((owner[:, 0] < warps).all() and (owner[:, 1] < 32).all()
                and (owner[:, 2] == 0).all())
    slots = owner[:, 0] * 32 + owner[:, 1]
    if n <= 32:       # the first warp's claim takes them all
        assert len(set(owner[:, 0].tolist())) == 1
        assert len(set(slots.tolist())) == n
    if n > warps * 32:  # slots were refilled
        assert len(set(slots.tolist())) < n
    # The lanes slot by slot, each slot's in the order it ran them, then
    # put back at their own indices: the one-lane-a-thread render.
    perm = torch.argsort(slots * (n + 1) + torch.arange(n))
    if n > 32:
        assert not torch.equal(perm, torch.arange(n))
    cfg_p = dataclasses.replace(cfg, use_pallas=False)
    o, d, t, rid = integrator._pixel_rays(cam, cfg_p, lane_start + perm,
                                          cfg.seed)
    out = integrator.trace_lanes(scene, static, cfg_p, o, d, t, rid,
                                 cfg.seed, emit_paths=True,
                                 emit_deferred=mk.defers(static))
    assert len(out) == len(ref)
    for got, want in zip(out, ref):
        back = torch.empty_like(got)
        back[perm] = got
        assert torch.equal(back, want)
    if n > 32:  # the window meets the media
        assert bool(((ref[2] & 3) == 3).any())


@pytest.mark.parametrize("name, warps", [("smokey_cornell_box", 2),
                                         ("book2_final_scene", 3)])
def test_phased_work_order_runs_each_lane_once(name, warps):
    """The phased launches of a depth-50 frame on media_kernel's slots: per
    phase, claim_order over the bounces each lane runs in the phase (at
    most its length) claims each lane once, and the phase's lanes rendered
    slot by slot in that order (phase_reference from the previous phase's
    state) and put back at their own indices give the in-order phase's
    radiance, segments, records and state bit for bit."""
    cfg = RenderConfig(width=16, height=9, samples_per_pixel=2, max_depth=50,
                       seed=3)
    scene, static, cam = _scene(name, cfg)
    n = cfg.n_rays
    lanes = torch.arange(n, dtype=torch.int32)
    state, d0, refilled, ragged = None, 0, 0, 0
    while d0 < cfg.max_depth and lanes.numel():
        cfg_p = dataclasses.replace(
            cfg, max_depth=min(mk.PHASE_LEN, cfg.max_depth - d0))
        ref = mk.phase_reference(scene, cfg_p, cam, lanes, state, d0,
                                 cfg.seed, static=static)
        m = lanes.numel()
        seg0 = 0 if state is None else state[:, 14].to(torch.int32)
        bounces = ref[1] - seg0
        assert bool((bounces >= 0).all()
                    and (bounces <= cfg_p.max_depth).all())
        ragged += int((bounces < cfg_p.max_depth).any())
        order, owner = mk.claim_order(bounces, warps, rays=1, seed=d0 + m)
        assert torch.equal(order.sort().values, torch.arange(m))
        assert bool((owner[:, 0] < warps).all() and (owner[:, 2] == 0).all())
        slots = owner[:, 0] * 32 + owner[:, 1]
        if m > warps * 32:  # slots were refilled
            assert len(set(slots.tolist())) < m
            refilled += 1
        perm = torch.argsort(slots * (m + 1) + torch.arange(m))
        got = mk.phase_reference(scene, cfg_p, cam, lanes[perm],
                                 None if state is None else state[perm], d0,
                                 cfg.seed, static=static)
        assert len(got) == len(ref) == (6 if mk.defers(static) else 3)
        for g, w in zip(got, ref):
            back = torch.empty_like(g)
            back[perm] = g
            assert torch.equal(back, w)
        alive = ref[-1][:, 13] > 0
        lanes, state = lanes[alive], ref[-1][alive].contiguous()
        d0 += cfg_p.max_depth
    # The first phase refilled its slots; lanes died inside the phases and
    # some lived past the first.
    assert refilled >= 1 and ragged >= 2 and d0 > mk.PHASE_LEN
