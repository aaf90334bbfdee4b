"""The media single pass (`media_kernel` in csrc/megakernel.cuh: K5, K5-emit
and K6a's records on scenes with media) through what the CPU can hold of it
(the card runs the kernel itself: `chip_smoke.py` phases 11 and 13,
`tests/test_torch_cuda.py`, `utils/ab_render.py`).

  * The route rule (`megakernel.fused_kernel`, a pure function of the
    scene's counts): the single pass of smokey_cornell_box, sphere_medium
    and book2_final_scene takes the media kernel, their phased launches
    stay on render_kernel, and the scenes without media keep theirs; the
    tables `build_tables` gives the media kernel are the ones it reads.
  * The module's mirrored compile-time constants are the kernel's.
  * Its work order (`claim_order` with one lane slot a thread, as
    `media_kernel` runs) runs each lane of a ragged window exactly once,
    and the lanes rendered slot by slot in that order and put back at
    their own indices are the one-lane-a-thread render bit for bit, codes
    and records included.
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
    assert mk.fused_kernel(R, V, phase=True) == "render_kernel"
    # The same scene without its media: its planar rows keep render_kernel.
    assert mk.fused_kernel(R, 0, phase=False) == "render_kernel"
    assert mk.fused_kernel(0, 0, phase=False) == "sphere_kernel"
    assert mk.fused_kernel(0, V, phase=False) == "media_kernel"
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
    # and render_kernel's media only phased, as fused_kernel says.
    cu = (CUH.parent / "megakernel.cu").read_text()
    assert "if (vol && !phase) {\n    const MediaTables T" in cu
    assert ('static_assert(!kVol || kPhase,\n'
            '                "the single pass with media is media_kernel\'s")'
            in src)
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
