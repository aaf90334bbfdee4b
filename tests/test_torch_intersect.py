"""The closest-hit kernels K10-K12 and the staged path through them, against JAX.

The port's `torch.autograd.Function`s (`ops/cuda/{sphere,rect,triangle}
_intersect.py`) run on the CPU: their forward is the plain brute force,
their backward the winner's one-row recompute. They are held against the
JAX package's `hit_*_pallas` run in Pallas interpret mode, as
tests/test_pallas_kernels.py and tests/test_pallas_rect.py run them, on
tables and rays drawn with numpy from a seed (B = 256 rays: axis-parallel
ones among them; a moving sphere, a hollow one, invalid rows, and a
duplicated row for the tie-break). t to rtol 1e-5 / atol 1e-6 where
finite, idx equal on every lane (misses give 0 in both), and the VJP of a
random cotangent of t with respect to every float table field, o, d and
time to rtol 1e-4 (plus 1e-6 of the output's largest entry, for the
entries that cancel to about 0).

Then the slice: the port's staged `render_chunk` with `use_pallas=True`
(the three Functions) against JAX `render_chunk` with `use_pallas=True`
inside `force_tpu_interpret_mode()`, at 16x9, 2 spp, depth 3, on
jumpy_balls, cornell_box and simple_triangle: radiance, and the gradient of
the radiance sum with respect to every float scene leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops.pallas import (
    hit_rects_pallas, hit_spheres_pallas, hit_triangles_pallas)
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu.scene import data as JD
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops.cuda import rect_intersect as RI
from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as SI
from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as TRI
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene import data as TD
from raytracer_weekend_tpu_torch.scene.data import SceneData

B = 256
T_MIN = 1e-3
T_RTOL, T_ATOL, VJP_RTOL = 1e-5, 1e-6, 1e-4


def _rays(rng, centers, spread):
    """B rays aimed near `centers` (P, 3), time in [0, 1); the first 12 are
    axis-parallel (+-x, +-y, +-z, twice), aimed along one axis at a center."""
    target = centers[rng.integers(0, len(centers), B)]
    target = target + rng.normal(size=(B, 3)) * spread
    o = target + rng.normal(size=(B, 3)) * 8.0
    d = target - o
    axes = np.concatenate([np.eye(3), -np.eye(3)] * 2)
    for i, ax in enumerate(axes):
        o[i] = target[i] - 6.0 * ax
        d[i] = ax
    time = rng.uniform(0.0, 1.0, B)
    f32 = np.float32
    return o.astype(f32), d.astype(f32), time.astype(f32)


def _spheres(rng):
    S = 64
    c0 = rng.normal(size=(S, 3)) * 3.0
    c1 = c0.copy()
    radius = rng.uniform(0.3, 1.2, S)
    t0, t1 = np.zeros(S), np.ones(S)
    c1[5] = c0[5] + (1.0, 0.0, 0.5)               # moving
    t0[5], t1[5] = 0.25, 0.75
    c0[6], radius[6] = c0[7], -0.8 * radius[7]    # hollow, inside sphere 7
    c0[20], radius[20] = c0[9], radius[9]         # duplicate of row 9
    c1[6], c1[20] = c0[6], c0[20]
    valid = np.ones(S, bool)
    valid[[3, 60, 61, 62, 63]] = False             # row 3 would be hit
    f32 = np.float32
    return [c0.astype(f32), c1.astype(f32), t0.astype(f32), t1.astype(f32),
            radius.astype(f32), np.zeros(S, np.int32), valid], c0


def _rects(rng):
    R = 120
    axis = (np.arange(R) % 3).astype(np.int32)
    a0, b0 = rng.uniform(-4, 2, R), rng.uniform(-4, 2, R)
    a1, b1 = a0 + rng.uniform(0.5, 3, R), b0 + rng.uniform(0.5, 3, R)
    k = rng.uniform(-4, 4, R)
    for f in (a0, a1, b0, b1, k):
        f[40] = f[10]                              # duplicate of row 10
    axis[40] = axis[10]
    valid = np.ones(R, bool)
    valid[[2, 117, 118, 119]] = False
    f32 = np.float32
    fields = [axis, a0.astype(f32), a1.astype(f32), b0.astype(f32),
              b1.astype(f32), k.astype(f32), np.zeros(R, np.int32), valid]
    ca, cb = (a0 + a1) / 2, (b0 + b1) / 2
    centers = np.stack([np.where(axis == 0, k, ca),
                        np.where(axis == 0, ca, np.where(axis == 1, k, cb)),
                        np.where(axis == 2, k, cb)], axis=1)
    return fields, centers


def _triangles(rng):
    T = 200
    base = rng.normal(size=(T, 1, 3)) * 3.0
    v = base + rng.normal(size=(T, 3, 3))
    v[50] = v[7]                                   # duplicate of row 7
    v[100, 2] = v[100, 0] + 2.0 * (v[100, 1] - v[100, 0])   # degenerate
    v0, v1, v2 = (v[:, i].astype(np.float32) for i in range(3))
    n = np.cross(v1 - v0, v2 - v0).astype(np.float32)
    uv = np.zeros((T, 2), np.float32)
    valid = np.ones(T, bool)
    valid[[4, 198, 199]] = False
    fields = [v0, v1, v2, n, n, n, uv, uv, uv, np.zeros(T, np.int32), valid]
    return fields, v.mean(axis=1)


FAMILIES = {
    # name: (table maker, JAX type, port type, JAX kernel, port Function,
    #        rays take time, ray spread)
    "spheres": (_spheres, JD.Spheres, TD.Spheres, hit_spheres_pallas,
                SI.hit_spheres_kernel, True, 0.5),
    "rects": (_rects, JD.Rects, TD.Rects, hit_rects_pallas,
              RI.hit_rects_kernel, False, 1.0),
    "triangles": (_triangles, JD.Triangles, TD.Triangles,
                  hit_triangles_pallas, TRI.hit_triangles_kernel, False, 0.3),
}


def _case(name, seed=6):
    make, spread = FAMILIES[name][0], FAMILIES[name][-1]
    rng = np.random.default_rng(seed)
    fields, centers = make(rng)
    o, d, time = _rays(rng, centers, spread)
    ct = rng.normal(size=B).astype(np.float32)
    return fields, (o, d, time), ct


def _jax_call(name, fields, rays):
    """JAX hit_*_pallas in interpret mode -> (t, idx) as numpy."""
    _, jtype, _, jfn, _, timed, _ = FAMILIES[name]
    tab = jtype(*map(jnp.asarray, fields))
    o, d, time = map(jnp.asarray, rays)
    args = (tab, o, d, time) if timed else (tab, o, d)
    with pltpu.force_tpu_interpret_mode():
        t, idx = jfn(*args, T_MIN)
    return np.asarray(t), np.asarray(idx)


def _torch_call(name, fields, rays):
    _, _, ttype, _, tfn, timed, _ = FAMILIES[name]
    tab = ttype(*map(torch.from_numpy, fields))
    o, d, time = map(torch.from_numpy, rays)
    args = (tab, o, d, time) if timed else (tab, o, d)
    t, idx = tfn(*args, T_MIN)
    return t.numpy(), idx.numpy()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_closest_hit_forward_matches_jax(name):
    fields, rays, _ = _case(name)
    t_j, i_j = _jax_call(name, fields, rays)
    t_t, i_t = _torch_call(name, fields, rays)
    assert i_t.dtype == np.int32 and t_t.dtype == np.float32
    hit = np.isfinite(t_j)
    assert 0.25 < hit.mean() < 0.95           # hits and misses both
    assert hit[:12].any()                     # an axis-parallel ray hits
    np.testing.assert_array_equal(np.isfinite(t_t), hit)
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(i_t, i_j)
    assert (i_t[~hit] == 0).all()
    # Invalid rows never win, though one lies where rays hit it.
    invalid = np.flatnonzero(~fields[-1])
    assert not np.isin(i_t[hit], invalid).any()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_closest_hit_tie_goes_to_lowest_row(name):
    """Each table holds a row twice (spheres 9 and 20, rects 10 and 40,
    triangles 7 and 50): rays aimed at that primitive get the same t from
    both rows, and the lower row wins in both packages."""
    fields, rays, _ = _case(name)
    dup, twin = {"spheres": (9, 20), "rects": (10, 40),
                 "triangles": (7, 50)}[name]
    # Aim every ray at the duplicated primitive's center.
    centers = FAMILIES[name][0](np.random.default_rng(6))[1]
    o = rays[0]
    d = (centers[dup] - o).astype(np.float32)
    rays = (o, d, rays[2])
    t_j, i_j = _jax_call(name, fields, rays)
    t_t, i_t = _torch_call(name, fields, rays)
    on_dup = i_j == dup
    assert on_dup.sum() > B // 8
    np.testing.assert_array_equal(i_t, i_j)
    assert not (i_t == twin).any()


def _vjp_jax(name, fields, rays, ct):
    _, jtype, _, jfn, _, timed, _ = FAMILIES[name]
    float_ix = [i for i, f in enumerate(fields) if f.dtype == np.float32]
    n_ray = 3 if timed else 2

    def loss(*xs):
        tab = list(map(jnp.asarray, fields))
        for i, x in zip(float_ix, xs[:len(float_ix)]):
            tab[i] = x
        args = (jtype(*tab), *xs[len(float_ix):])
        with pltpu.force_tpu_interpret_mode():
            t, _ = jfn(*args, T_MIN)
        return jnp.sum(jnp.where(jnp.isfinite(t), t * jnp.asarray(ct), 0.0))

    xs = [jnp.asarray(fields[i]) for i in float_ix] + \
        [jnp.asarray(r) for r in rays[:n_ray]]
    grads = jax.grad(loss, argnums=tuple(range(len(xs))))(*xs)
    return [np.asarray(g) for g in grads]


def _vjp_torch(name, fields, rays, ct):
    _, _, ttype, _, tfn, timed, _ = FAMILIES[name]
    tab = [torch.from_numpy(f) for f in fields]
    xs = [t.requires_grad_() for t in tab if t.is_floating_point()]
    n_ray = 3 if timed else 2
    ray_t = [torch.from_numpy(r).requires_grad_() for r in rays[:n_ray]]
    t, _ = tfn(ttype(*tab), *ray_t, T_MIN)
    loss = torch.where(torch.isfinite(t), t * torch.from_numpy(ct), 0.0).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, xs + ray_t)]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_closest_hit_vjp_matches_jax(name):
    fields, rays, ct = _case(name)
    want = _vjp_jax(name, fields, rays, ct)
    got = _vjp_torch(name, fields, rays, ct)
    assert len(got) == len(want)
    nonzero = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=VJP_RTOL, atol=1e-6 * scale)
        nonzero += scale > 0
    # Geometry, o and d (and time for a moving sphere) all get gradients.
    assert nonzero >= {"spheres": 6, "rects": 3, "triangles": 5}[name]


# ---- the slice: the staged path through K10-K12 -----------------------------

SLICE = dict(width=16, height=9, samples_per_pixel=2, max_depth=3, seed=3)
SLICE_SCENES = {"jumpy_balls": "spheres", "cornell_box": "rects",
                "simple_triangle": "triangles"}


def _slice_scenes(name):
    """Both packages' builds of a catalog scene at SLICE; cornell_box gets a
    gray background for its black one, since at depth 3 no lane of 288
    reaches its light (the open front lets paths out to the background)."""
    jc = JConfig(use_pallas=True, **SLICE)
    tc = TConfig(use_pallas=True, **SLICE)
    gray = (0.5, 0.5, 0.5) if name == "cornell_box" else None
    objs, jcams, bg = getattr(JS, name)(jc.aspect_ratio, seed=0)
    js, jst = JB.build_scene(objs, background=gray or bg, seed=jc.seed,
                             bvh=False)
    objs, tcams, bg = getattr(TS, name)(tc.aspect_ratio, seed=0)
    ts, tst = TB.build_scene(objs, background=gray or bg, seed=tc.seed,
                             bvh=False)
    return (js, jst, jc, jcams[0]), (ts, tst, tc, tcams[0])


def _jax_slice(j, w=None):
    """JAX render_chunk(use_pallas=True), Pallas in interpret mode ->
    (radiance, float-leaf gradients of sum(w * radiance) or None)."""
    js, jst, jc, cam = j
    ids = jnp.arange(jc.n_rays, dtype=jnp.int32)

    def rad_of(sc):
        with pltpu.force_tpu_interpret_mode():
            return JI.render_chunk(sc, jst, jc, cam, ids, jnp.uint32(jc.seed))

    rad = np.asarray(rad_of(js))
    if w is None:
        return rad, None
    g = jax.grad(lambda sc: jnp.sum(jnp.asarray(w)[:, None] * rad_of(sc)),
                 allow_int=True)(js)
    return rad, [np.asarray(le) for le in jtu.tree_leaves(g)
                 if le.dtype != jax.dtypes.float0]


def _torch_slice(t, w=None, cfg=None):
    ts, tst, tc, cam = t
    cfg = cfg or tc
    leaves = [le.detach().clone() for le in ts.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    rad = TI.render_chunk(SceneData.from_leaves(leaves), tst, cfg, cam,
                          torch.arange(cfg.n_rays), cfg.seed)
    if w is None:
        return rad.detach().numpy(), None
    grads = torch.autograd.grad((torch.from_numpy(w)[:, None] * rad).sum(),
                                floats, allow_unused=True)
    return rad.detach().numpy(), [
        np.zeros(f.shape, np.float32) if g is None else g.numpy()
        for f, g in zip(floats, grads)]


@pytest.mark.parametrize("name", list(SLICE_SCENES))
def test_staged_kernels_slice_matches_jax(name):
    """Radiance to atol 1e-5 but for near-tangent flips (lanes beyond it
    at most max(2, n // 500), the budget of tests/test_torch_render.py's
    staged comparisons); then the gradient of the radiance sum over the
    lanes where the two radiances agree to 1e-5 (a flipped lane's gradient
    belongs to another path), leaf by leaf to rtol 1e-3, and the launch
    counts unchanged (the CPU runs the Functions' plain forwards)."""
    j, t = _slice_scenes(name)
    n = t[2].n_rays
    launches = SI.LAUNCHES, RI.LAUNCHES, TRI.LAUNCHES
    rad_j, _ = _jax_slice(j)
    rad_t, _ = _torch_slice(t)
    same = np.isclose(rad_t, rad_j, rtol=0, atol=1e-5).all(axis=1)
    assert (~same).sum() <= max(2, n // 500)
    assert (rad_j.max(axis=1) > 0).mean() > 0.5
    w = same.astype(np.float32)
    _, g_j = _jax_slice(j, w)
    _, g_t = _torch_slice(t, w)
    assert (SI.LAUNCHES, RI.LAUNCHES, TRI.LAUNCHES) == launches
    want, _ = convert.grads_from_numpy(t[0], g_j)
    got, _ = convert.grads_from_numpy(t[0], g_t)
    gscale = max(float(np.abs(x).max()) for x in g_j)
    live = 0
    for lg, lw in zip(got.leaves(), want.leaves()):
        if lw is None:
            continue
        g, r = lg.numpy(), lw.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-6 * gscale)
        live += float(np.abs(r).max()) > 0
    # Solid and checker textures make geometry gradients exactly 0 (both
    # packages): cornell_box's live leaves are its colors and background;
    # simple_triangle's uv-debug texture gives its vertices gradients
    # through K12's backward.
    assert live >= (2 if name == "cornell_box" else 3)
    if name == "simple_triangle":
        assert np.abs(got.triangles.v0.numpy()).max() > 0


@pytest.mark.parametrize("name", list(SLICE_SCENES))
def test_staged_use_pallas_false_is_plain(name):
    """use_pallas=False takes the plain brute force: bitwise the staged
    path of the default config on the CPU ("auto"), and the kernels'
    Functions (use_pallas=True) give the same radiance there too."""
    _, t = _slice_scenes(name)
    tc = t[2]
    plain, _ = _torch_slice(t, cfg=dataclasses.replace(tc, use_pallas=False))
    auto, _ = _torch_slice(t, cfg=dataclasses.replace(tc, use_pallas="auto"))
    kern, _ = _torch_slice(t, cfg=tc)
    np.testing.assert_array_equal(plain, auto)
    np.testing.assert_array_equal(plain, kern)


def test_edge_lanes_hold_out_checker_cell_flips():
    """many_spheres (3,970 spheres on a checker ground) on the CPU: over all
    lanes the float32 plain replay backward is off float64 by the few lanes
    whose hit points sit within rounding of a checker cell edge; with the
    lanes `checks.edge_lanes` marks held out (at most 1%) it agrees to
    1e-5. This is the witness behind K2's hold-out on the card."""
    from raytracer_weekend_tpu_torch.ops.cuda import checks
    from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd

    cfg = TConfig(width=32, height=18, samples_per_pixel=4, max_depth=6,
                  use_pallas=False)
    objs, cams, bg = TS.many_spheres(cfg.aspect_ratio)
    scene, static = TB.build_scene(objs, background=bg)
    n = cfg.n_rays
    o, d, t, rid = TI._pixel_rays(cams[0], cfg, torch.arange(n), cfg.seed)
    rad, _, codes = TI.trace_lanes(scene, static, cfg, o, d, t, rid,
                                   cfg.seed, emit_paths=True)
    edge = checks.edge_lanes(scene, static, cfg, o, d, t, rid, codes,
                             [slice(0, n)])
    assert int(edge.sum()) <= n // 100
    g = 2.0 * rad * (~edge).float()[:, None]
    ktab = replay_bwd.pack_ktab(scene).detach()

    def backward(dtype):
        return replay_bwd.replay_bwd_reference(
            ktab.to(dtype), None, scene.background.to(dtype), cfg,
            o.to(dtype), d.to(dtype), t.to(dtype), rid, cfg.seed, codes,
            g.to(dtype))

    got, ref = backward(torch.float32), backward(torch.float64)
    for i in (0, 5):                                   # d(ktab), d(bg)
        err = float((got[i].double() - ref[i]).norm() / ref[i].norm())
        assert err <= 1e-5, (i, err)
