"""The two design rules of the forward kernel's closest hit, through their
plain twins in `ops/cuda/megakernel.py` (the card runs the kernels
themselves: `chip_smoke.py` phases 7, 11 and 12, `tests/test_torch_cuda.py`).

  * The planar loop divides only for candidates: `plane_candidate_plain`,
    the kernel's division-free prefilter bit for bit, passes every row
    whose IEEE t = num / den satisfies t >= t_min && t < best, on the
    adversarial and random float32 cases of `checks.candidate_cases`
    (den = +-0, subnormals, +-inf, NaN, best = inf, t one and two ulps on
    either side of t_min and of best), and rejects rows clearly outside.
  * A group of G lanes carries one ray in the phased launches:
    `closest_hit_grouped` (the kernel's sphere and affine planar tests over
    `build_sphere_table` / `build_planar_table`, the primitives split into
    G strided subsets, merged by the lexicographic minimum of (t, family,
    index)) is bitwise its G = 1 result for G in {2, 4, 32}, on book2 rays
    and on exact ties; and its G = 1 winners, followed by the media, are
    JAX `integrator._closest_hit`'s, family and index, on all but the
    lanes of the planar flip budget of tests/test_megakernel.py:119-128
    (n // 100: the affine test and the staged one round differently on
    wall corners and cuboid edges); where they agree, t within 1e-5 max(1,
    |t|) on all but n // 200 lanes and within 1e-4 max(1, |t|) on all: on a
    small sphere far from the origin (book2's cluster, ~1,000 units from the
    camera), disc = hb^2 - a c cancels to about r^2 / |o - c|^2 of hb^2, and
    the kernel's grouping of c (|o|^2 - 2 o.c + K0) and the staged (o - c)
    form each keep their own ~1e-5 of t (11 of ~1,500 lanes here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops import volume as vol_ops
from raytracer_weekend_tpu_torch.ops.cuda import checks
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.scene import builder as TB

# Lanes whose family or index may differ from JAX's (the planar flip
# budget); t's tolerance where they agree, the lanes allowed beyond it
# (n // T_LANES) and the bound on every lane.
FLIP_LANES, T_RTOL, T_LANES, T_RTOL_ALL = 100, 1e-5, 200, 1e-4


# ---- the division-free candidate test ----------------------------------------

@pytest.mark.parametrize("t_min", checks.CAND_T_MINS)
def test_candidate_test_contains_exact_test(t_min):
    num, den, best = map(torch.from_numpy,
                         checks.candidate_cases(t_min, 1 << 18, seed=3))
    exact = checks.exact_accepts(num, den, best, t_min)
    cand = mk.plane_candidate_plain(num, den, t_min, best)
    missed = exact & ~cand
    assert int(missed.sum()) == 0, (num[missed][:8], den[missed][:8],
                                    best[missed][:8])
    assert int(exact.sum()) > 10_000
    # It prunes: a row with a normal-range quotient clearly outside
    # [t_min, best) fails, unless a bound fell into its 2^-100 guard.
    with np.errstate(all="ignore"):
        q = (num.double() / den.double()).abs()
    dp = den.abs().double()
    normal = (torch.isfinite(q) & (num != 0) & (dp * t_min > 2.0**-90)
              & (dp * best.double() < 1e38) & (num.sign() == den.sign()))
    outside = (q < t_min * (1 - 2.0**-18)) | (q > best.double()
                                               * (1 + 2.0**-18))
    assert int((normal & outside).sum()) > 10_000
    assert int((cand & normal & outside).sum()) == 0


def test_candidate_test_edges():
    """Rows the exact test accepts at its edges pass; rows it can never
    accept (den = 0, NaN, behind the ray) fail."""
    f32 = np.float32
    tm = f32(1e-3)
    up = np.nextafter(tm, f32(np.inf))
    best = f32(2.0)
    below = np.nextafter(best, f32(0.0))
    num = torch.tensor([tm, up, below, 1.0, 1.0, 0.0, np.nan, -1.0, 1.0],
                       dtype=torch.float32)
    den = torch.tensor([1.0, 1.0, 1.0, 1e-40, 0.0, 0.0, 1.0, 1.0, -0.0],
                       dtype=torch.float32)
    bests = torch.tensor([best, best, best, np.inf, best, best, best, best,
                          best], dtype=torch.float32)
    got = mk.plane_candidate_plain(num, den, float(tm), bests).tolist()
    assert got == [True, True, True, True, False, False, False, False,
                   False]


# ---- the grouped closest hit --------------------------------------------------

def _book2():
    """Port and JAX book2 (seed 0) and rays: 48x27 primary lanes and 1,024
    rays from around the camera into the scene's box."""
    cfg = RenderConfig(width=48, height=27, samples_per_pixel=1, max_depth=8)
    objs, cams, bg = TS.book2_final_scene(cfg.aspect_ratio, seed=0)
    scene, static = TB.build_scene(objs, background=bg, seed=cfg.seed,
                                   bvh=False)
    jo, _, jbg = JS.book2_final_scene(cfg.aspect_ratio, seed=0)
    js, jst = JB.build_scene(jo, background=jbg, seed=cfg.seed, bvh=False)
    ids = torch.arange(cfg.n_rays)
    o, d, t, rid = integrator._pixel_rays(cams[0], cfg, ids, 5)
    g = np.random.default_rng(8)
    m = 1024
    o2 = g.uniform([350, 150, -650], [600, 400, -450], (m, 3))
    aim = g.uniform([-200, 0, -200], [600, 500, 600], (m, 3))
    o = torch.cat([o, torch.from_numpy(o2).float()])
    d = torch.cat([d, torch.from_numpy(aim - o2).float()])
    t = torch.cat([t, torch.from_numpy(g.uniform(0, 1, m)).float()])
    rid = torch.cat([rid, cfg.n_rays + torch.arange(m)])
    return scene, static, js, jst, cfg, o, d, t, rid


@pytest.fixture(scope="module")
def book2():
    scene, static, js, jst, cfg, o, d, t, rid = _book2()
    tab = mk.build_sphere_table(scene)
    ptab = mk.build_planar_table(scene, static)
    g1 = mk.closest_hit_grouped(tab, ptab, o, d, t, cfg.t_min, 1)
    return scene, static, js, jst, cfg, o, d, t, rid, tab, ptab, g1


@pytest.mark.parametrize("group", [2, 4, 32])
def test_grouped_closest_hit_equals_one_lane(book2, group):
    *_, o, d, t, rid, tab, ptab, g1 = book2
    got = mk.closest_hit_grouped(tab, ptab, o, d, t, 1e-3, group)
    for a, b in zip(got, g1):
        assert torch.equal(a, b)
    fam = g1[1]
    assert int((fam == 0).sum()) > 100 and int((fam == 1).sum()) > 100


def test_one_lane_closest_hit_matches_jax(book2):
    scene, static, js, jst, cfg, o, d, t, rid, tab, ptab, g1 = book2
    seed, depth = 5, 1
    t_s, fam, idx, _, _ = g1
    # The media merge last, against the surfaces' best (strict <).
    t_v, i_v = vol_ops.hit_volumes(scene.volumes, o, d, cfg.t_min, seed,
                                   rid, depth,
                                   use_log10=cfg.use_log10_volume_sampling)
    vol = t_v < t_s
    t_all = torch.where(vol, t_v, t_s)
    nr = static.n_rects
    jfam = torch.where(fam == 0, 0, torch.where(idx < nr, 1, 2))
    jfam = torch.where(vol, 3, torch.where(fam == 2, -1, jfam))
    jidx = torch.where((fam == 1) & (idx >= nr), idx - nr, idx)
    jidx = torch.where(vol, i_v, torch.where(fam == 2, 0, jidx))
    jc = JConfig(width=cfg.width, height=cfg.height, samples_per_pixel=1,
                 max_depth=8, use_pallas=False)
    jt, jf, ji = JI._closest_hit(js, jst, jnp.asarray(o.numpy()),
                                 jnp.asarray(d.numpy()),
                                 jnp.asarray(t.numpy()), jnp.uint32(seed),
                                 jnp.asarray(rid.numpy().astype(np.uint32)),
                                 jnp.uint32(depth), jc)
    jt, jf, ji = (torch.from_numpy(np.asarray(x).astype(np.float64))
                  for x in (jt, jf, ji))
    n = o.shape[0]
    same = (jf == jfam.double()) & ((ji == jidx.double()) | (jf == -1))
    assert int((~same).sum()) <= max(4, n // FLIP_LANES)
    hit = same & (jf >= 0)
    assert int(hit.sum()) > n // 3 and int((jf == 3).sum()) > 10
    rel = (t_all.double() - jt).abs()[hit] / jt[hit].abs().clamp_min(1.0)
    assert int((rel > T_RTOL).sum()) <= n // T_LANES
    assert bool((rel <= T_RTOL_ALL).all())


def _ties():
    """Exact ties: five copies of a unit sphere, four of a triangle, and a
    sphere whose top meets an XZ rect at the same t; rays straight down
    the axis of each (t is exact in float32)."""
    white = TB.Lambertian((0.5, 0.5, 0.5))
    objs = [TB.Sphere((0.0, 0.0, 0.0), 1.0, white) for _ in range(5)]
    objs += [TB.Sphere((6.0, 0.0, 0.0), 1.0, white),
             TB.XZRectangle(4.0, 8.0, -2.0, 2.0, 1.0, white)]
    objs += [TB.Triangle.flat_shaded(((10.0, 0.0, -1.0), (13.0, 0.0, -1.0),
                                      (10.0, 0.0, 2.0)), white)
             for _ in range(4)]
    objs += [TB.Sphere((20.0, float(k), 3.0), 0.5, white) for k in range(7)]
    scene, static = TB.build_scene(objs)
    o = torch.tensor([[0.0, 5.0, 0.0], [6.0, 5.0, 0.0], [11.0, 5.0, 0.0],
                      [0.0, 5.0, 0.5], [11.0, 3.0, 0.25]])
    d = torch.tensor([[0.0, -1.0, 0.0]] * 5)
    return scene, static, o, d


@pytest.mark.parametrize("group", [2, 4, 32])
def test_grouped_closest_hit_exact_ties(group):
    scene, static, o, d = _ties()
    tab = mk.build_sphere_table(scene)
    ptab = mk.build_planar_table(scene, static)
    tm = torch.zeros(o.shape[0])
    g1 = mk.closest_hit_grouped(tab, ptab, o, d, tm, 1e-3, 1)
    got = mk.closest_hit_grouped(tab, ptab, o, d, tm, 1e-3, group)
    for a, b in zip(got, g1):
        assert torch.equal(a, b)
    t, fam, idx, _, _ = g1
    r = {k: tab[i] for i, k in enumerate(mk.TABLE_ROWS)}
    at_origin = ((r["c0x"] == 0) & (r["c0y"] == 0) & (r["c0z"] == 0)
                 & (r["radius"] == 1)).nonzero().squeeze(1)
    assert len(at_origin) == 5
    # The lowest of the five copies, at t = 4; the sphere, not the rect,
    # at t = 4 on the second ray; the lowest of the four triangles at 5.
    assert fam[0] == 0 and idx[0] == int(at_origin.min()) and t[0] == 4.0
    assert fam[1] == 0 and t[1] == 4.0
    assert fam[2] == 1 and t[2] == 5.0
    p = {k: ptab[i] for i, k in enumerate(mk.PLANAR_ROWS)}
    tris = (p["flag"] == 1).nonzero().squeeze(1)
    assert idx[2] == int(tris.min()) and idx[4] == int(tris.min())
    assert fam[3] == 0 and idx[3] == int(at_origin.min())
