"""The sphere-only single pass (`sphere_kernel` in csrc/megakernel.cuh: K1,
K1-emit and K6a on sphere scenes) through what the CPU can hold of it (the
card runs the kernel itself: `chip_smoke.py` phases 4-6 and 9,
`tests/test_torch_cuda.py`, `utils/ab_render.py`).

  * Its packed rows (`build_sphere_rows`: three float4 a sphere, (c0, k0),
    (dc, k1), (t0, inv_dt, k2, 0)) hold exactly the `build_sphere_table`
    values they replace, a padding row's +inf k0 included, on jumpy_balls,
    two_perlin_spheres, earth and many_spheres, as `build_tables` packs
    them.
  * The module's mirrored compile-time constants (lane slots a thread,
    block, rows kept in shared memory, float4 a row) are the kernel's.
  * Its work order (`claim_order`, the plain twin of the persistent warps'
    claims: a shared counter, one claim a warp for all of its empty slots,
    warps in a random order) runs each lane of a ragged window exactly once
    (a window smaller than one warp, one not a multiple of the block, a
    lane_start > 0), and the lanes rendered slot by slot in that order and
    put back at their own indices are the one-lane-a-thread render bit for
    bit: a lane's outputs depend on its id alone.
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


def _scene(name, cfg):
    if name in scenes.SCENES:
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device="cpu")
    else:
        objs, cams, bg = getattr(scenes, name)(cfg.aspect_ratio)
        scene, static = build_scene(objs, background=bg)
    return scene, static, cams[0]


@pytest.mark.parametrize("name", ["jumpy_balls", "two_perlin_spheres",
                                  "earth", "many_spheres"])
def test_packed_rows_hold_the_table(name):
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=1, max_depth=4)
    scene, static, cam = _scene(name, cfg)
    # A padding row (an invalid sphere) is part of the table the kernel
    # reads: r2 = -inf, k0 = +inf.
    sp = scene.spheres
    valid = sp.valid.clone()
    valid[-1] = False
    tab = mk.build_sphere_table(scene._replace(
        spheres=sp._replace(valid=valid)))
    rows = mk.build_sphere_rows(tab)
    S = tab.shape[1]
    assert S == static.n_spheres
    assert rows.shape == (S, 12) and rows.dtype == torch.float32
    assert rows.is_contiguous()
    q = rows.view(S, 3, 4)          # the kernel's three float4 a row
    r = {k: tab[i] for i, k in enumerate(mk.TABLE_ROWS)}
    want = [["c0x", "c0y", "c0z", "k0"], ["dcx", "dcy", "dcz", "k1"],
            ["t0", "inv_dt", "k2", None]]
    for j, cols in enumerate(want):
        for c, key in enumerate(cols):
            ref = torch.zeros(S) if key is None else r[key]
            assert torch.equal(q[:, j, c].view(torch.int32),
                               ref.view(torch.int32)), (j, key)
    assert q[-1, 0, 3] == torch.inf and bool(torch.isfinite(q[:-1, 0]).all())
    tables = mk.build_tables(scene, static, cam)
    assert torch.equal(tables[5], mk.build_sphere_rows(tables[0]))


def test_mirrored_constants_are_the_kernels():
    src = CUH.read_text()
    got = {m[0]: int(m[1]) for m in
           re.findall(r"constexpr int kSphere(Rays|Block|RowLimit|Q) = (\d+);",
                      src)}
    assert got == {"Rays": mk.SPHERE_RAYS, "Block": mk.SPHERE_BLOCK,
                   "RowLimit": mk.SPHERE_ROW_LIMIT,
                   "Q": len(mk.SPHERE_ROW_COLS) // 4}
    # A resident table of SPHERE_ROW_LIMIT rows needs no opt-in above the
    # default 48 KB of dynamic shared memory.
    assert mk.SPHERE_ROW_LIMIT * 4 * len(mk.SPHERE_ROW_COLS) <= 48 * 1024


@pytest.fixture(scope="module")
def jumpy():
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6,
                       seed=3)
    scene, static, cam = _scene("jumpy_balls", cfg)
    return scene, static, cfg, cam


@pytest.mark.parametrize("lane_start, n, warps", [
    (0, 5, 3),        # a window smaller than one warp
    (0, 1037, 4),     # not a multiple of the block; slots refilled
    (300, 1037, 40),  # lane_start > 0; more slots than lanes
])
def test_work_order_runs_each_lane_once(jumpy, lane_start, n, warps):
    scene, static, cfg, cam = jumpy
    ref = mk.records_reference(scene, cfg, cam, lane_start, n, cfg.seed,
                               static=static, emit_paths=True)
    seg = ref[1]
    order, owner = mk.claim_order(seg, warps, seed=n)
    assert torch.equal(order.sort().values, torch.arange(n))
    assert bool((owner[:, 0] < warps).all() and (owner[:, 1] < 32).all()
                and (owner[:, 2] < mk.SPHERE_RAYS).all())
    slots = owner[:, 0] * 32 * mk.SPHERE_RAYS + owner[:, 1] * \
        mk.SPHERE_RAYS + owner[:, 2]
    if n <= 32 * mk.SPHERE_RAYS:    # the first warp's claim takes them all
        assert len(set(owner[:, 0].tolist())) == 1
        assert len(set(slots.tolist())) == n
    if n > warps * 32 * mk.SPHERE_RAYS:  # slots were refilled
        assert len(set(slots.tolist())) < n
    # The lanes slot by slot, each slot's in the order it ran them, then
    # put back at their own indices: the one-lane-a-thread render.
    perm = torch.argsort(slots * (n + 1) + torch.arange(n))
    if n > 32 * mk.SPHERE_RAYS:
        assert not torch.equal(perm, torch.arange(n))
    cfg_p = dataclasses.replace(cfg, use_pallas=False)
    o, d, t, rid = integrator._pixel_rays(cam, cfg_p, lane_start + perm,
                                          cfg.seed)
    out = integrator.trace_lanes(scene, static, cfg_p, o, d, t, rid,
                                 cfg.seed, emit_paths=True)
    for got, want in zip(out, ref):
        back = torch.empty_like(got)
        back[perm] = got
        assert torch.equal(back, want)
