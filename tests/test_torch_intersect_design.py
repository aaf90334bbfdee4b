"""The design rules of the staged path's closest-hit kernels K10, K11 and
K12, through their plain twins (the card runs the kernels themselves:
`chip_smoke.py` phase 14, `utils/ab_render.py`, `tests/test_torch_cuda.py`).

  * K12 divides only for candidates: `tri_candidate_plain`, the kernel's
    division-free prefilter bit for bit, passes every pair the exact test
    (`checks.tri_exact_accepts`) takes, on the adversarial and random cases
    of `checks.tri_candidate_cases` and on 2^20 pairs of random rays and
    triangles, for each t_min of 1e-3, 0.5 and 7, and on hand-built edges
    (det = +-0 and subnormal, u + v = 1 exactly, u_num underflowing to -0,
    t = t_min, t equal to best); and it rejects most pairs that miss.
  * K10 takes the roots only where disc > 0: `hit_spheres_twin` (the
    plain version's pairwise terms in the kernel's order, the roots behind
    disc > 0) is `ops.sphere.hit_spheres` bit for bit on jumpy_balls'
    primary and first-bounce rays and on a random table with moving,
    hollow, invalid, degenerate (t0 = t1) and duplicated rows, with rays
    of |time| > 2^30 and an infinite component.
  * K11's twin, `hit_rects_twin` (the packed rows of `rect_table` in the
    kernel's order, R rays a thread), is `ops.rect.hit_rects` bit for bit
    on cornell_box's primary and first-bounce rays and on a random table
    with invalid, duplicated and degenerate (a0 = a1) rows and rays with
    d_f = +-0 or an infinite component, for each t_min of 1e-3, 0.5 and 7
    and at t_min = 0; `rect_table`'s packed columns are the plain
    version's fields.
  * R rays a thread: the twins' loop order (`kernel_order_walk`, the
    kernels' deal of rays to threads, tiles of rows) with R in {1, 2} and
    ragged tiles is the one-ray loop (R = 1, one tile) bit for bit, for
    spheres, rects and, with the prefilter against the running best,
    triangles; the twins' defaults are the kernels' compile-time
    constants.
  * Prebuilt tables: on a card the staged path builds each family's kernel
    table once a trace from the detached fields (`integrator.kernel_tables`,
    the plain version's terms laid out). On the CPU it builds none (the
    Functions run the plain versions on the fields), and tables built as on
    a card change no value or gradient of `render_chunk(use_pallas=True)`
    or of two steps of `InverseRenderer.fit`; built as on a card, each
    trace builds them once and a parameter changed in place between two
    traces reaches the second one's table. (tests/test_torch_intersect.py
    holds the same path against JAX; tests/test_torch_cuda.py the tables
    on the card.)
"""

import re

import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models import scenes
from raytracer_weekend_tpu_torch.ops import rect as rect_ops
from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops
from raytracer_weekend_tpu_torch.ops import triangle as tri_ops
from raytracer_weekend_tpu_torch.ops.cuda import checks
from raytracer_weekend_tpu_torch.ops.cuda import rect_intersect as RI
from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as SI
from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as TRI
from raytracer_weekend_tpu_torch.scene.builder import build_scene
from raytracer_weekend_tpu_torch.scene.data import SceneData
from raytracer_weekend_tpu_torch.train import InverseRenderer

SMALL = dict(width=48, height=27, samples_per_pixel=2, max_depth=4)


def _pairs(n_rays, n_tris, seed):
    """(det, u_num, v_num, t_num) of every pair of n_rays random rays and
    n_tris random triangles, as the plain version computes them."""
    g = np.random.default_rng(seed)
    tab, _ = checks.random_hit_case("triangles", "cpu", 16)
    v = g.normal(size=(n_tris, 1, 3)) * 3 + g.normal(size=(n_tris, 3, 3))
    tab = tab._replace(**{k: torch.from_numpy(v[:, i]).float()
                          for i, k in enumerate(("v0", "v1", "v2"))})
    o = torch.from_numpy(g.normal(size=(n_rays, 3)) * 6).float()
    d = torch.from_numpy(g.normal(size=(n_rays, 3))).float()
    nrm, ab, ac, ac_x_v0, ab_x_v0, v0_n = tri_ops.triangle_terms(tab)
    w = torch.linalg.cross(o, d, dim=-1)
    det = -(d @ nrm.T)
    u_num = (w @ ac.T) - (d @ ac_x_v0.T)
    v_num = -((w @ ab.T) - (d @ ab_x_v0.T))
    t_num = (o @ nrm.T) - v0_n[None, :]
    return [x.reshape(-1) for x in (det, u_num, v_num, t_num)]


@pytest.mark.parametrize("t_min", checks.CAND_T_MINS)
def test_tri_candidate_contains_exact_test(t_min):
    """Adversarial cases and 2^20 random ones, then 2^20 pairs of random
    rays and triangles against a best of +inf, of the pair's own t (one ulp
    above, equal) and of 4 t_min."""
    det, un, vn, tn, best = map(torch.from_numpy, checks.tri_candidate_cases(
        t_min, 1 << 20, seed=5))
    exact = checks.tri_exact_accepts(det, un, vn, tn, t_min, best)
    cand = TRI.tri_candidate_plain(det, un, vn, tn, t_min, best)
    missed = exact & ~cand
    assert int(missed.sum()) == 0, [x[missed][:8] for x in (det, un, vn, tn,
                                                            best)]
    assert int(exact.sum()) > 10_000
    nums = _pairs(1024, 1024, seed=6)
    inv = 1.0 / torch.where(nums[0] == 0, 1.0, nums[0])
    t = nums[3] * inv
    g = torch.Generator().manual_seed(7)
    pick = torch.randint(0, 4, t.shape, generator=g)
    up = torch.nextafter(t, torch.tensor(math.inf))
    best = torch.where(pick == 0, math.inf, torch.where(
        pick == 1, up, torch.where(pick == 2, t, 4 * t_min)))
    best = torch.where(best >= t_min, best, math.inf)
    exact = checks.tri_exact_accepts(*nums, t_min, best)
    cand = TRI.tri_candidate_plain(*nums, t_min, best)
    assert int((exact & ~cand).sum()) == 0
    assert int(exact.sum()) > 100
    # It prunes: of the pairs the exact test refuses, it passes few.
    assert int((cand & ~exact).sum()) < int((~exact).sum()) // 50


def test_tri_candidate_edges():
    """Pairs at the exact test's edges: det = +-0 (refused) and subnormal,
    u + v = 1 exactly, u_num underflowing to -0 against |det| >= 2 (u = -0
    passes u >= 0), t = t_min, t one ulp below best (taken) and t equal to
    best (refused). Every pair the exact test takes passes the prefilter."""
    f32 = np.float32
    tm = f32(1e-3)
    best = f32(2.0)
    below = np.nextafter(best, f32(0.0))
    # (det, u_num, v_num, t_num, best, exact)
    cases = [
        (0.0, 0.2, 0.3, 1.0, np.inf, False),
        (-0.0, 0.2, 0.3, 1.0, np.inf, False),
        (1e-40, 2e-41, 3e-41, 1e-40, np.inf, False),   # 1 / det = inf
        (-1e-40, -2e-41, -3e-41, -1e-40, np.inf, False),
        (1.1754944e-38, 2e-39, 3e-39, 1.1754944e-38, np.inf, True),
        (1.0, 0.25, 0.75, 1.0, np.inf, True),           # u + v = 1
        (-4.0, -1.0, -3.0, -4.0, np.inf, True),
        # v one ulp above 0.75: u + v = 1 + 2^-24 rounds (to even) to 1;
        # two ulps: 1 + 2^-23 > 1.
        (1.0, 0.25, np.nextafter(f32(0.75), f32(1)), 1.0, np.inf, True),
        (1.0, 0.25, f32(0.75) + f32(2**-23), 1.0, np.inf, False),
        (4.0, -1e-45, 0.5, 1.0, np.inf, True),          # u = -0
        (-4.0, 1e-45, -0.5, -1.0, np.inf, True),
        (1.0, -1e-45, 0.5, 1.0, np.inf, False),         # u = -1e-45
        (1.0, 0.2, 0.3, tm, np.inf, True),              # t = t_min
        (1.0, 0.2, 0.3, np.nextafter(tm, f32(0)), np.inf, False),
        (1.0, 0.2, 0.3, below, best, True),             # t < best
        (1.0, 0.2, 0.3, best, best, False),             # t = best
        (3.0, 0.6, 0.9, 3.0 * below, best, True),
        (1.0, np.nan, 0.3, 1.0, np.inf, False),
        (1.0, 0.2, 0.3, -1.0, np.inf, False),
    ]
    det, un, vn, tn, bst = (torch.tensor([c[i] for c in cases],
                                         dtype=torch.float32)
                            for i in range(5))
    exact = checks.tri_exact_accepts(det, un, vn, tn, float(tm), bst)
    assert exact.tolist() == [c[5] for c in cases]
    cand = TRI.tri_candidate_plain(det, un, vn, tn, float(tm), bst)
    assert bool(cand[exact].all())
    assert not bool(cand[:2].any())       # det = +-0
    assert not bool(cand[-2:].any())      # NaN, behind the ray


def _frame_rays(name, size=SMALL):
    """A catalog scene on the CPU and its (primary, first-bounce) rays."""
    cfg = RenderConfig(**size)
    scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                device="cpu")
    ids = torch.arange(cfg.n_rays)
    o, d, t, rid = integrator._pixel_rays(cams[0], cfg, ids, cfg.seed)
    *_, (o1, d1, _, _, alive, _) = integrator.trace_lanes(
        scene, static, dataclasses.replace(cfg, max_depth=1), o, d, t, rid,
        cfg.seed, return_carry=True)
    return scene, (o, d, t), (o1[alive], d1[alive], t[alive])


def _sphere_table_case():
    """checks.random_hit_case's spheres (moving, hollow, invalid rows) with
    a degenerate row (t0 = t1: w is +-inf or NaN), duplicated rows (exact
    ties), and extreme rays: |time| > 2^30, an infinite direction."""
    tab, (o, d, t) = checks.random_hit_case("spheres", "cpu", 4096)
    fields = {k: v.clone() for k, v in tab._asdict().items()}
    fields["valid"][[3, 7, 11]] = True
    fields["t1"][7] = fields["t0"][7]
    for dst, src in ((20, 3), (21, 3), (40, 11)):
        for k in fields:
            fields[k][dst] = fields[k][src]
    t = t.clone()
    d = d.clone()
    t[100] = 2.0**31
    t[700] = 2.0**30
    d[1500, 0] = math.inf
    return type(tab)(**fields), (o, d, t)


def _sphere_cases():
    jumpy, primary, bounce = _frame_rays("jumpy_balls")
    return {"jumpy primary": (jumpy.spheres, primary),
            "jumpy first bounce": (jumpy.spheres, bounce),
            "random": _sphere_table_case()}


@pytest.fixture(scope="module")
def sphere_cases():
    return _sphere_cases()


@pytest.mark.parametrize("case", ["jumpy primary", "jumpy first bounce",
                                  "random"])
def test_sphere_twin_is_plain(sphere_cases, case):
    sp, (o, d, t) = sphere_cases[case]
    got_t, got_i = SI.hit_spheres_twin(sp, o, d, t, 1e-3)
    want_t, want_i = sphere_ops.hit_spheres(sp, o, d, t, 1e-3)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_i.long(), want_i)
    assert int(torch.isfinite(got_t).sum()) > o.shape[0] // 4


def test_sphere_table_flags():
    """The packed tables lay out the plain version's terms and the valid
    flag."""
    sp, _ = _sphere_table_case()
    tab = SI.sphere_table(sp)
    assert tab.shape == (sp.c0.shape[0], len(SI.TABLE_ROWS))
    dc, dt, r2, c0_sq, c0_dc, dc_sq = sphere_ops.sphere_terms(sp)
    cols = dict(zip(SI.TABLE_ROWS, tab.unbind(1)))
    for name, want in (("c0x", sp.c0[:, 0]), ("dcz", dc[:, 2]), ("dt", dt),
                       ("r2", r2), ("c0_sq", c0_sq), ("c0_dc", c0_dc),
                       ("dc_sq", dc_sq), ("t0", sp.t0),
                       ("valid", sp.valid.float())):
        assert torch.equal(cols[name], want), name
    assert 0 < int(sp.valid.sum()) < sp.valid.shape[0]
    tr = scenes.generate_scene("cornell_box", 1.0, device="cpu")[0].triangles
    ttab = TRI.triangle_table(tr)
    n, ab, ac, ac_x_v0, ab_x_v0, v0_n = tri_ops.triangle_terms(tr)
    tcols = dict(zip(TRI.TABLE_ROWS, ttab.unbind(1)))
    for name, want in (("nx", n[:, 0]), ("v0n", v0_n), ("acy", ac[:, 1]),
                       ("acv0z", ac_x_v0[:, 2]), ("abx", ab[:, 0]),
                       ("abv0y", ab_x_v0[:, 1]),
                       ("valid", tr.valid.float())):
        assert torch.equal(tcols[name], want), name


@pytest.mark.parametrize("mod,prefix", [(SI, "kSph"), (RI, "kRect"),
                                        (TRI, "kTri")])
def test_twin_defaults_are_kernel_constants(mod, prefix):
    """The twins walk in the kernel's order: RAYS, BLOCK and TILE are
    csrc/intersect.cu's compile-time constants, and the packed row is a
    whole number of float4."""
    src = (pathlib.Path(SI.__file__).parents[2] / "csrc"
           / "intersect.cu").read_text()
    got = {k: int(v) for k, v in
           re.findall(rf"{prefix}(Rays|Block|Tile) = (\d+)", src)}
    assert got == {"Rays": mod.RAYS, "Block": mod.BLOCK, "Tile": mod.TILE}
    assert len(mod.TABLE_ROWS) % 4 == 0


# The R-rays-a-thread cases: every (rays, block, tile) below leaves a ragged
# last block of rays (ORDER_RAYS is no multiple of rays * block) and a
# ragged last tile of rows (ORDER_ROWS is no multiple of the tile, and
# above it): the random tables' first ORDER_ROWS rows (their degenerate,
# duplicated and invalid rows among them) and first ORDER_RAYS rays (the
# axis-parallel and extreme ones among them), and ORDER_ROWS random
# triangles.
ORDER_ROWS, ORDER_RAYS = 150, 1537


def _rows(table, n):
    return table._replace(**{k: v[:n] for k, v in table._asdict().items()})


@pytest.fixture(scope="module")
def order_cases(sphere_cases, rect_cases):
    """family -> (twin, table, rays, the one-ray loop's outputs)."""
    sp, rays = sphere_cases["random"]
    rc, rect_rays = rect_cases["random"]
    tr, tri_rays = checks.random_hit_case("triangles", "cpu", ORDER_RAYS,
                                          rows=ORDER_ROWS)
    cases = {"spheres": (SI.hit_spheres_twin, _rows(sp, ORDER_ROWS),
                         tuple(r[:ORDER_RAYS] for r in rays)),
             "rects": (RI.hit_rects_twin, _rows(rc, ORDER_ROWS),
                       tuple(r[:ORDER_RAYS] for r in rect_rays)),
             "triangles": (TRI.hit_triangles_twin, tr, tri_rays[:2])}
    return {k: (twin, tab, rays, twin(tab, *rays, 1e-3, rays=1, block=32,
                                      tile=ORDER_ROWS))
            for k, (twin, tab, rays) in cases.items()}


@pytest.mark.parametrize("rays,block,tile", [(2, 32, 64), (2, 64, 7),
                                             (1, 128, 128)])
def test_rays_a_thread_order_is_one_ray_loop(order_cases, rays, block, tile):
    """R rays a thread over ragged tiles: bitwise the one-ray loop (R = 1,
    one tile), spheres, rects and triangles (K12's prefilter against each
    ray's running best: no pair the exact test would take is refused)."""
    assert ORDER_RAYS % (rays * block) and ORDER_ROWS % tile
    assert ORDER_ROWS > tile
    for kind in ("spheres", "rects"):
        twin, tab, r, one = order_cases[kind]
        got = twin(tab, *r, 1e-3, rays=rays, block=block, tile=tile)
        assert all(torch.equal(a, b) for a, b in zip(got, one)), kind
        assert int(torch.isfinite(got[0]).sum()) > 100, kind
    twin, tr, (o, d), (t1, i1, s1) = order_cases["triangles"]
    assert o.shape[0] % (rays * block)
    tr_t, tr_i, stats = twin(tr, o, d, 1e-3, rays=rays, block=block,
                             tile=tile)
    assert torch.equal(tr_t, t1) and torch.equal(tr_i, i1)
    want_t, want_i = tri_ops.hit_triangles(tr, o, d, 1e-3)
    assert torch.equal(tr_t, want_t) and torch.equal(tr_i.long(), want_i)
    assert stats == s1 and stats["missed"] == 0
    assert int(torch.isfinite(tr_t).sum()) > 100
    assert 0 < stats["divides"] < stats["pairs"] // 20


def _rect_table_case():
    """checks.random_hit_case's rects (all three axes, 5% invalid rows;
    its first 6 rays axis-parallel, so d_f = 0 against two axes) with
    degenerate rows (a0 = a1, b0 = b1), duplicated rows (exact ties), a
    row whose k is a ray's own o_f (num = 0), and rays with d_f = -0 and
    with an infinite component of d and of o."""
    rc, (o, d, _) = checks.random_hit_case("rects", "cpu", 4096)
    fields = {k: v.clone() for k, v in rc._asdict().items()}
    fields["valid"][[3, 5, 9, 11]] = True
    fields["a1"][5] = fields["a0"][5]
    fields["b1"][9] = fields["b0"][9]
    for dst, src in ((20, 3), (21, 3), (40, 11)):
        for k in fields:
            fields[k][dst] = fields[k][src]
    o, d = o.clone(), d.clone()
    d[6:9] = torch.tensor([[1.0, -0.0, 0.5], [-0.0, 0.0, -1.0],
                           [0.3, 1.0, -0.0]])
    d[9, 0], d[10, 2], o[11, 1] = math.inf, -math.inf, -math.inf
    fields["k"][12] = o[12, int(fields["axis"][12])]
    return type(rc)(**fields), (o, d)


def _rect_cases():
    cornell, primary, bounce = _frame_rays("cornell_box")
    return {"cornell primary": (cornell.rects, primary[:2]),
            "cornell first bounce": (cornell.rects, bounce[:2]),
            "random": _rect_table_case()}


@pytest.fixture(scope="module")
def rect_cases():
    return _rect_cases()


@pytest.mark.parametrize("t_min", [*checks.CAND_T_MINS, 0.0])
@pytest.mark.parametrize("case", ["cornell primary", "cornell first bounce",
                                  "random"])
def test_rect_twin_is_plain(rect_cases, case, t_min):
    """K11's twin (packed rows, the kernel's order, R rays a thread): the
    plain version's bits."""
    rc, (o, d) = rect_cases[case]
    t, i = RI.hit_rects_twin(rc, o, d, t_min)
    want_t, want_i = rect_ops.hit_rects(rc, o, d, t_min)
    assert torch.equal(t, want_t) and torch.equal(i.long(), want_i)
    if t_min < 7.0:
        assert int(torch.isfinite(t).sum()) > o.shape[0] // 4


def test_rect_table_columns():
    """The packed rect table lays out the plain version's fields, the axis
    id and valid as floats, and pads each row to two float4."""
    rc, _ = _rect_table_case()
    tab = RI.rect_table(rc)
    assert tab.shape == (rc.k.shape[0], len(RI.TABLE_ROWS))
    assert len(RI.TABLE_ROWS) == 8 and tab.dtype == torch.float32
    cols = dict(zip(RI.TABLE_ROWS, tab.unbind(1)))
    for name in ("k", "a0", "a1", "b0", "b1"):
        assert torch.equal(cols[name], getattr(rc, name)), name
    assert torch.equal(cols["axis"], rc.axis.float())
    assert torch.equal(cols["valid"], rc.valid.float())
    assert not cols["pad"].any()
    assert set(cols["axis"].tolist()) == {0.0, 1.0, 2.0}
    assert 0 < int(rc.valid.sum()) < rc.valid.shape[0]


def test_triangle_twin_is_plain_on_cornell():
    """K12's twin on cornell_box's primary and first-bounce rays (24
    triangles): the plain version's bits, no pair missed."""
    scene, primary, bounce = _frame_rays("cornell_box")
    for o, d, _ in (primary, bounce):
        t, i, stats = TRI.hit_triangles_twin(scene.triangles, o, d, 1e-3)
        want_t, want_i = tri_ops.hit_triangles(scene.triangles, o, d, 1e-3)
        assert torch.equal(t, want_t) and torch.equal(i.long(), want_i)
        assert stats["missed"] == 0 and stats["divides"] < stats["pairs"]


# ---- prebuilt tables ------------------------------------------------------------

def _scene(name, cfg):
    """A catalog scene or a test scene of `models.scenes`, on the CPU."""
    if name in scenes.SCENES:
        return scenes.generate_scene(name, cfg.aspect_ratio, device="cpu")
    objs, cams, bg = getattr(scenes, name)(cfg.aspect_ratio)
    return (*build_scene(objs, background=bg), cams)


def _uvdebug():
    cfg = RenderConfig(**SMALL, use_pallas=True)
    scene, static, cams = _scene("jumpy_balls_uvdebug", cfg)
    return scene, static, cfg, cams[0]


def _no_builds(monkeypatch):
    """Kernel-table builders that fail the test if called."""
    def fail(*_):
        raise AssertionError("a kernel table was built on the CPU")

    for mod, name in ((SI, "sphere_table"), (RI, "rect_table"),
                      (TRI, "triangle_table")):
        monkeypatch.setattr(mod, name, fail)


def _card_tables(monkeypatch):
    """`kernel_tables` as on a card: each present family's table built."""
    real = integrator.kernel_tables
    monkeypatch.setattr(integrator, "kernel_tables",
                        lambda scene, static, cfg, _: real(scene, static, cfg,
                                                           "cuda"))


def _grad_render(scene, static, cfg, cam):
    leaves = [le.detach().clone() for le in scene.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    rad = integrator.render_chunk(SceneData.from_leaves(leaves), static, cfg,
                                  cam, torch.arange(cfg.n_rays), cfg.seed)
    grads = torch.autograd.grad(rad.sum(), floats, allow_unused=True)
    return rad, grads


@pytest.mark.parametrize("name", ["jumpy_balls_uvdebug", "cornell_box"])
def test_prebuilt_tables_render_chunk_unchanged(monkeypatch, name):
    cfg = RenderConfig(**SMALL, use_pallas=True)
    scene, static, cams = _scene(name, cfg)
    with monkeypatch.context() as m:
        _no_builds(m)
        rad, grads = _grad_render(scene, static, cfg, cams[0])
    with monkeypatch.context() as m:
        _card_tables(m)
        ref, ref_grads = _grad_render(scene, static, cfg, cams[0])
    assert torch.equal(rad, ref)
    for g, r in zip(grads, ref_grads):
        assert (g is None) == (r is None)
        assert g is None or torch.equal(g, r)
    assert any(g is not None and bool(g.abs().max() > 0) for g in grads)


def test_prebuilt_tables_fit_unchanged(monkeypatch):
    scene, static, cfg, cam = _uvdebug()
    target = integrator.render_image(scene, static, cfg, cam) / \
        cfg.samples_per_pixel
    start = scene._replace(textures=scene.textures._replace(
        color1=scene.textures.color1 + 0.2))

    def fit():
        fitted, hist = InverseRenderer(static, cfg, cam, target).fit(
            start, steps=2)
        return fitted, [float(h) for h in hist]

    with monkeypatch.context() as m:
        _no_builds(m)
        fitted, hist = fit()
    with monkeypatch.context() as m:
        _card_tables(m)
        ref, ref_hist = fit()
    assert hist == ref_hist and hist[-1] != hist[0]
    assert all(torch.equal(a, b) for a, b in zip(fitted.leaves(),
                                                 ref.leaves()))


def test_tables_built_once_a_trace_and_fresh(monkeypatch):
    """Built as on a card, each trace builds each family's table once (not
    once a bounce), and a sphere radius changed in place between two traces
    is in the second trace's table."""
    scene, static, cfg, cam = _uvdebug()
    built = []
    real = SI.sphere_table
    monkeypatch.setattr(SI, "sphere_table",
                        lambda sp: built.append(real(sp)) or built[-1])
    _card_tables(monkeypatch)
    counts = SI.LAUNCHES, RI.LAUNCHES, TRI.LAUNCHES
    ids = torch.arange(cfg.n_rays)
    with torch.no_grad():
        first = integrator.render_chunk(scene, static, cfg, cam, ids, 0)
        scene.spheres.radius[1:] *= 1.5
        second = integrator.render_chunk(scene, static, cfg, cam, ids, 0)
    assert len(built) == 2 and cfg.max_depth > 1
    r2 = SI.TABLE_ROWS.index("r2")
    assert torch.equal(built[1][:, r2],
                       scene.spheres.radius * scene.spheres.radius)
    assert not torch.equal(built[0][:, r2], built[1][:, r2])
    assert not torch.equal(first, second)
    assert (SI.LAUNCHES, RI.LAUNCHES, TRI.LAUNCHES) == counts   # the CPU
