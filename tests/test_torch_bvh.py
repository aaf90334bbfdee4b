"""The port's BVH against the JAX package: the C++ builder and its trees, the
plain `ops.bvh.traverse`, the BVH kernel's autograd.Function on the CPU and
the staged path through a tree.

Every case of tests/test_bvh.py is here through the port (layout
invariants; the C++ builder against its numpy plain version; traversal
against the brute force for triangles and spheres; the image with a tree
against the image without). Then, against the JAX package on the same
inputs: the port's trees bit-equal to JAX `native.build_bvh`'s for a random
set and for the JAX `generate_scene` book2 and cow (bvh="auto", trees
included); the port's `traverse` against JAX's on the same tree and rays (t
within 1e-6 relative, prim equal on every lane that hits); a ray whose slab
time is 0 * inf = NaN misses the box in both, as the kernel must; the
Function's gradient against torch autograd of the plain traverse (float64,
1e-6); and the port's staged render through a tree (`use_pallas=False`,
the plain traverse) against JAX's CPU staged render of the same scene
built with bvh=True, within tests/test_torch_planar.py's staged budgets.

The C++ builder splits at the median with `std::nth_element`, the numpy
version with a stable argsort: on centroids tied at a split (a mesh's
regular vertices: the cow's 5,804 triangles have 2,123 distinct centroid
x) the two put different tied primitives on each side. Both are the JAX
package's, and the port's C++ trees are bit-equal to JAX's; against the
numpy version the trees are equal where no split has a tie (book2's
spheres, random sets) and of the same shape (inner nodes, skip links, one
leaf per primitive) on the meshes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu import native as jnative
from raytracer_weekend_tpu.camera import make_camera as jmake_camera
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops import bvh as jbvh
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch import native
from raytracer_weekend_tpu_torch.camera import make_camera as tmake_camera
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops import bvh as tbvh
from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops
from raytracer_weekend_tpu_torch.ops import triangle as tri_ops
from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as BT
from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as SI
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene.data import SceneData

T_MIN = 1e-3
ASPECT = 16 / 9


def _boxes(g, n, spread=1.0):
    lo = (g.normal(size=(n, 3)) * spread).astype(np.float32)
    hi = lo + g.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    return lo, hi


def _tri_objs(B, g, n=150):
    mat = B.Lambertian((1, 1, 1))
    return [B.Triangle.flat_shaded(g.normal(size=3) * 3
                                   + g.normal(size=(3, 3)), mat)
            for _ in range(n)]


def _sphere_objs(B, g, n=600):
    mat = B.Lambertian((1, 1, 1))
    return [B.Sphere(tuple(c), r, mat) for c, r in
            zip(g.normal(size=(n, 3)) * 8, g.uniform(0.2, 1.0, n))]


def _rays(g, n, scale):
    o = torch.from_numpy((g.normal(size=(n, 3)) * scale).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    return o, d


def _scene_boxes(scene, kind):
    """The boxes the builder gives `kind`'s tree (the JAX builder's)."""
    if kind == "spheres":
        sp = scene.spheres
        c0, c1 = sp.c0.numpy(), sp.c1.numpy()
        r = np.abs(sp.radius.numpy())[:, None]
        return np.minimum(c0 - r, c1 - r), np.maximum(c0 + r, c1 + r)
    tr = scene.triangles
    v = np.stack([tr.v0.numpy(), tr.v1.numpy(), tr.v2.numpy()], axis=1)
    lo, hi = v.min(axis=1), v.max(axis=1)
    thin = (hi - lo) < 2e-4
    return np.where(thin, lo - 1e-4, lo), np.where(thin, hi + 1e-4, hi)


def _camera_rays(name, width, spp):
    """A catalog scene built by both packages under bvh="auto" and the
    port's primary rays (o, d, time) at width x (width / ASPECT) x spp."""
    cfg = TConfig.from_aspect(width=width, aspect_ratio=ASPECT,
                              samples_per_pixel=spp, max_depth=4)
    ts, tst, tcams = TS.generate_scene(name, ASPECT, device="cpu")
    js, jst, _ = JS.generate_scene(name, ASPECT)
    o, d, t, _ = TI._pixel_rays(tcams[0], cfg, torch.arange(cfg.n_rays), 0)
    return (ts, tst), (js, jst), (o, d, t)


# ---- the builder ----------------------------------------------------------------

def test_builder_layout_invariants(rng):
    n = 200
    lo, hi = _boxes(rng, n)
    nb, nx, prim, skip = native.build_bvh(lo, hi)
    m = len(prim)
    assert nb.dtype == np.float32 and prim.dtype == np.int32
    assert m == 2 * n - 1
    # Every primitive appears in exactly one leaf.
    assert sorted(prim[prim >= 0].tolist()) == list(range(n))
    # Skip links are strictly forward and land inside [i+1, m].
    assert ((skip > np.arange(m)) & (skip <= m)).all()
    # Parent boxes contain their subtree's boxes.
    for i in range(m):
        if prim[i] < 0:
            sub = slice(i + 1, skip[i])
            assert (nb[i] <= nb[sub] + 1e-6).all()
            assert (nx[i] >= nx[sub] - 1e-6).all()
    assert all(x.shape[0] == 0 for x in native.build_bvh(lo[:0], hi[:0]))


@pytest.mark.parametrize("case", ["random", "book2", "cow"])
def test_native_matches_numpy_fallback(rng, case):
    """The C++ builder against its numpy plain version: bit-equal without
    centroid ties (73 random boxes, book2's spheres), the same shape on
    the cow (see the module docstring)."""
    if case == "random":
        lo, hi = _boxes(rng, 73)
    else:
        name, kind = {"book2": ("book2_final_scene", "spheres"),
                      "cow": ("wavefront_cow_obj", "triangles")}[case]
        objs, _, bg = getattr(TS, name)(ASPECT)
        lo, hi = _scene_boxes(TB.build_scene(objs, background=bg,
                                             bvh=False)[0], kind)
    a = native.build_bvh(lo, hi)
    b = native._build_bvh_numpy(lo, hi)
    if case == "cow":
        np.testing.assert_array_equal(a[3], b[3])          # skip links
        np.testing.assert_array_equal(a[2] < 0, b[2] < 0)  # inner nodes
        assert sorted(a[2][a[2] >= 0]) == sorted(b[2][b[2] >= 0])
        np.testing.assert_array_equal(a[0][0], b[0][0])    # the root box
        np.testing.assert_array_equal(a[1][0], b[1][0])
        assert not np.array_equal(a[2], b[2])              # ties split
    else:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["random", "book2_final_scene",
                                  "wavefront_cow_obj"])
def test_trees_bit_equal_jax(rng, case):
    """The port's trees are JAX's, bit for bit: `native.build_bvh` of a
    random set, and the JAX `generate_scene` (bvh="auto") book2 and cow,
    which `scene_from_numpy` now takes with their trees."""
    if case == "random":
        lo, hi = _boxes(rng, 300, spread=4.0)
        for x, y in zip(native.build_bvh(lo, hi), jnative.build_bvh(lo, hi)):
            np.testing.assert_array_equal(x, np.asarray(y))
        return
    ts, tst, _ = TS.generate_scene(case, ASPECT, device="cpu")
    js, jst, _ = JS.generate_scene(case, ASPECT)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert (tst.sphere_bvh, tst.triangle_bvh) == (
        case == "book2_final_scene", case == "wavefront_cow_obj")
    back = convert.scene_from_numpy(jtu.tree_map(np.asarray, js))
    for tree in ("sphere_bvh", "triangle_bvh"):
        got, want, cross = (getattr(s, tree) for s in (ts, js, back))
        assert (got is None) == (want is None) == (cross is None)
        if got is None:
            continue
        for f in tbvh.Bvh._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
            assert torch.equal(getattr(cross, f), getattr(got, f))
    assert len(ts.leaves()) == len(jtu.tree_leaves(js))
    for a, b in zip(ts.leaves(), back.leaves()):
        assert torch.equal(a, b)


# ---- traversal -----------------------------------------------------------------

def test_traversal_matches_brute_force_triangles(rng):
    scene, static = TB.build_scene(_tri_objs(TB, rng), bvh=True)
    assert static.triangle_bvh and not static.sphere_bvh
    o, d = _rays(rng, 256, 5.0)
    t_ref, i_ref = tri_ops.hit_triangles(scene.triangles, o, d, T_MIN)
    t_bvh, i_bvh = tbvh.traverse(
        scene.triangle_bvh, o, d, T_MIN,
        tbvh.triangle_prim_test(scene.triangles, o, d, T_MIN))
    np.testing.assert_allclose(t_bvh.numpy(), t_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    hit = torch.isfinite(t_ref)
    assert int(hit.sum()) > 20
    assert torch.equal(i_bvh.long()[hit], i_ref[hit])
    assert i_bvh.dtype == torch.int32 and not i_bvh[~hit].any()


def test_traversal_matches_brute_force_spheres(rng):
    scene, static = TB.build_scene(_sphere_objs(TB, rng), bvh=True)
    assert static.sphere_bvh
    o, d = _rays(rng, 256, 10.0)
    time = torch.zeros(256)
    t_ref, _ = sphere_ops.hit_spheres(scene.spheres, o, d, time, T_MIN)
    t_bvh, _ = tbvh.traverse(
        scene.sphere_bvh, o, d, T_MIN,
        tbvh.sphere_prim_test(scene.spheres, o, d, time, T_MIN))
    # The expanded brute force and the oc-based leaf test associate the
    # quadratic differently; near-tangent lanes differ at ~1e-4 relative.
    np.testing.assert_allclose(t_bvh.numpy(), t_ref.numpy(), rtol=2e-3,
                               atol=1e-4)
    assert int(torch.isfinite(t_ref).sum()) > 20


def test_render_identical_with_and_without_bvh(rng):
    """The plain staged render through the trees (spheres and triangles)
    against the brute force: the same image."""
    objs = []
    for _ in range(100):
        c = rng.normal(size=3) * np.array([4, 1, 4]) + np.array([0, 0, -6])
        objs.append(TB.Sphere(tuple(c), 0.4,
                              TB.Lambertian(tuple(rng.uniform(0.2, 0.9, 3)))))
    for _ in range(80):
        base = rng.normal(size=3) * np.array([3, 1, 3]) + np.array([0, 1, -6])
        v = base + rng.normal(size=(3, 3)) * 0.6
        objs.append(TB.Triangle.flat_shaded(
            v, TB.Lambertian(tuple(rng.uniform(0.2, 0.9, 3)))))
    cfg = TConfig(width=10, height=5, samples_per_pixel=2, max_depth=3,
                  seed=4)
    cam = tmake_camera((0, 1, 2), (0, 0, -6), (0, 1, 0), 50.0,
                       cfg.aspect_ratio, 0.0, 6.0, 0.0, 1.0)
    scene_bf, static_bf = TB.build_scene(objs, bvh=False)
    scene_bvh, static_bvh = TB.build_scene(objs, bvh=True)
    assert static_bvh.sphere_bvh and static_bvh.triangle_bvh
    assert TI.hit_routes(scene_bvh, static_bvh, cfg, "cpu") == dict(
        spheres="tree", rects="plain", triangles="tree")
    img_bf = TI.render_image(scene_bf, static_bf, cfg, cam)
    img_bvh = TI.render_image(scene_bvh, static_bvh, cfg, cam)
    np.testing.assert_allclose(img_bvh.numpy(), img_bf.numpy(), rtol=1e-5,
                               atol=1e-5)


def _jax_traverse(kind, scene, o, d, time):
    o, d = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    if kind == "spheres":
        test = jbvh.sphere_prim_test(scene.spheres, o, d,
                                     jnp.asarray(time.numpy()), T_MIN)
        tree = scene.sphere_bvh
    else:
        test = jbvh.triangle_prim_test(scene.triangles, o, d, T_MIN)
        tree = scene.triangle_bvh
    with jax.disable_jit():      # op by op: no fusion, no contraction
        t, prim = jbvh.traverse(tree, o, d, T_MIN, test)
    return np.asarray(t), np.asarray(prim)


def _port_traverse(kind, scene, o, d, time):
    if kind == "spheres":
        return tbvh.traverse(scene.sphere_bvh, o, d, T_MIN,
                             tbvh.sphere_prim_test(scene.spheres, o, d, time,
                                                   T_MIN))
    return tbvh.traverse(scene.triangle_bvh, o, d, T_MIN,
                         tbvh.triangle_prim_test(scene.triangles, o, d,
                                                 T_MIN))


@pytest.mark.parametrize("case", ["book2_final_scene", "wavefront_cow_obj",
                                  "random triangles", "random spheres"])
def test_traverse_matches_jax(rng, case):
    """The port's traverse against JAX's on the same tree and rays: t within
    1e-6 relative, prim equal on every lane that hits (misses: +inf and 0
    in both). The catalog scenes on their camera rays (book2's moving
    spheres at the rays' shutter times), the random sets on rays from all
    around."""
    if case.startswith("random"):
        kind = case.split()[1]
        objs = (_tri_objs if kind == "triangles" else _sphere_objs)
        js, _ = JB.build_scene(objs(JB, np.random.default_rng(3)), bvh=True)
        ts, _ = TB.build_scene(objs(TB, np.random.default_rng(3)), bvh=True)
        o, d = _rays(rng, 512, 6.0)
        time = torch.from_numpy(rng.random(512).astype(np.float32))
    else:
        kind = "spheres" if case == "book2_final_scene" else "triangles"
        (ts, _), (js, _), (o, d, time) = _camera_rays(case, 32, 1)
    t, prim = _port_traverse(kind, ts, o, d, time)
    jt, jprim = _jax_traverse(kind, js, o, d, time)
    hit = np.isfinite(jt)
    assert int(hit.sum()) > 50
    np.testing.assert_array_equal(np.isfinite(t.numpy()), hit)
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(prim.numpy()[hit], jprim[hit])
    assert not prim.numpy()[~hit].any() and not jprim[~hit].any()


def test_nan_slab_misses_the_box():
    """A ray with d.x = 0 whose o.x lies on a box's x plane gets a slab time
    (bmin.x - o.x) / d.x = 0 * inf = NaN: the box misses in the JAX
    traverse (jnp.minimum/maximum propagate NaN) and in the port's, though
    the brute force hits the triangle on that edge; a ray off the plane
    hits in all three."""
    objs = [TB.Triangle.flat_shaded(((0, 0, 0), (1, 0, 0), (0, 1, 0)),
                                    TB.Lambertian((1, 1, 1))),
            TB.Triangle.flat_shaded(((3, 0, 0), (4, 0, 0), (3, 1, 0)),
                                    TB.Lambertian((1, 1, 1)))]
    jobjs = [JB.Triangle.flat_shaded(((0, 0, 0), (1, 0, 0), (0, 1, 0)),
                                     JB.Lambertian((1, 1, 1))),
             JB.Triangle.flat_shaded(((3, 0, 0), (4, 0, 0), (3, 1, 0)),
                                     JB.Lambertian((1, 1, 1)))]
    ts, _ = TB.build_scene(objs, bvh=True)
    js, _ = JB.build_scene(jobjs, bvh=True)
    x0 = float(ts.triangle_bvh.bmin[0, 0])     # the root's x plane
    o = torch.tensor([[x0, 0.2, -1.0], [0.1, 0.2, -1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, prim = _port_traverse("triangles", ts, o, d, None)
    jt, jprim = _jax_traverse("triangles", js, o, d, None)
    t_bf, _ = tri_ops.hit_triangles(ts.triangles, o, d, T_MIN)
    assert bool(torch.isfinite(t_bf).all())
    assert t[0] == float("inf") and not np.isfinite(jt[0])
    assert float(t[1]) == float(jt[1]) == 1.0 and prim[1] == jprim[1]


@pytest.mark.parametrize("kind", ["spheres", "triangles"])
def test_function_grad_matches_autograd(rng, kind):
    """The BVH Function on the CPU (the plain traverse, then the winner's
    one-row recompute) against torch autograd of the plain traverse, in
    float64: t bit for bit, and the VJP of a random cotangent with respect
    to every float table field, o, d (and time) to 1e-6."""
    objs = _sphere_objs(TB, rng, 300) if kind == "spheres" else _tri_objs(
        TB, rng, 120)
    for i, ob in enumerate(objs[:40] if kind == "spheres" else []):
        objs[i] = TB.MovingSphere(ob.center, 0.0,
                                  tuple(np.add(ob.center, (0.3, 0.1, 0))),
                                  1.0, ob.radius, ob.material)
    scene, _ = TB.build_scene(objs, bvh=True)
    tree = scene.sphere_bvh if kind == "spheres" else scene.triangle_bvh
    table = scene.spheres if kind == "spheres" else scene.triangles
    o, d = _rays(rng, 256, 8.0 if kind == "spheres" else 5.0)
    time = torch.from_numpy(rng.random(256).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=256))

    def leaves():
        fields = [f.double().requires_grad_() if f.is_floating_point() else f
                  for f in table]
        rays = [o.double().requires_grad_(), d.double().requires_grad_()]
        if kind == "spheres":
            rays.append(time.double().requires_grad_())
        return type(table)(*fields), rays

    tab, rays = leaves()
    if kind == "spheres":
        t, prim = BT.traverse_spheres(tree, tab, *rays, T_MIN)
    else:
        t, prim = BT.traverse_triangles(tree, tab, *rays, T_MIN)
    wrt = [f for f in tab if f.requires_grad] + rays
    got = torch.autograd.grad(t, wrt, torch.where(torch.isfinite(t), ct, 0.0),
                              allow_unused=True)
    tab2, rays2 = leaves()
    t2, prim2 = _port_traverse(kind, scene._replace(**{kind: tab2}),
                               *rays2[:2],
                               rays2[2] if kind == "spheres" else None)
    wrt2 = [f for f in tab2 if f.requires_grad] + rays2
    want = torch.autograd.grad(t2, wrt2,
                               torch.where(torch.isfinite(t2), ct, 0.0),
                               allow_unused=True)
    assert torch.equal(t.detach(), t2.detach()) and torch.equal(prim, prim2)
    assert int(torch.isfinite(t).sum()) > 30
    for g, w in zip(got, want):
        w = torch.zeros_like(g) if w is None else w
        scale = float(w.abs().max()) or 1.0
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * scale)
    assert any(float(g.abs().max()) > 0 for g in got)


# ---- the staged path -------------------------------------------------------------

def _flips(got, ref, got_seg, ref_seg):
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-3)
    bad = len(np.unique(np.argwhere(rel > 0.05)[:, 0]))
    return abs(int(got_seg) - int(ref_seg)), bad, float(np.abs(got - ref).mean())


def _mixed(B, make_camera, aspect):
    """Spheres and triangles over a ground: trees over both under bvh=True."""
    g = np.random.default_rng(8)
    objs = [B.Sphere((0, -1000, 0), 999.0, B.Lambertian((0.5, 0.5, 0.5)))]
    for _ in range(60):
        c = g.normal(size=3) * np.array([4, 0.8, 4]) + np.array([0, 0.5, -6])
        objs.append(B.Sphere(tuple(c), 0.4, B.Metal(
            tuple(g.uniform(0.3, 0.9, 3)), 0.2)))
    for _ in range(70):
        base = g.normal(size=3) * np.array([3, 0.8, 3]) + np.array([0, 1, -6])
        objs.append(B.Triangle.flat_shaded(
            base + g.normal(size=(3, 3)) * 0.6,
            B.Lambertian(tuple(g.uniform(0.2, 0.9, 3)))))
    cam = make_camera((0, 1.5, 3), (0, 0.5, -6), (0, 1, 0), 45.0, aspect,
                      0.0, 9.0, 0.0, 1.0)
    return objs, [cam], (0.7, 0.8, 1.0)


@pytest.mark.parametrize("name,op_by_op", [("mixed", True),
                                           ("wavefront_cow_obj", False)])
def test_render_chunk_with_tree_matches_jax(name, op_by_op):
    """The port's staged trace with use_pallas=False, walking the trees
    (the plain traverse), against JAX's CPU staged trace of the same scene
    built with bvh=True (its `lax.while_loop` traverse), within
    tests/test_torch_planar.py's staged budgets. The cow against JAX
    compiled (as tests/test_torch_planar.py runs it), the mixed scene
    against JAX op by op: compiled, XLA fuses the loop's products into
    FMAs, and one of its 288 lanes at 16x9x2 d3 took another branch (its
    radiance 0.24 off, the mean 6.9e-4); op by op every lane is the
    port's, bit for bit."""
    size = (dict(width=12, height=7, samples_per_pixel=2, max_depth=3)
            if op_by_op else dict(width=16, height=9, samples_per_pixel=2,
                                  max_depth=4))
    size["seed"] = 3
    jc, tc = JConfig(use_pallas=False, **size), TConfig(use_pallas=False,
                                                       **size)
    if name == "mixed":
        jo, jcams, jbg = _mixed(JB, jmake_camera, jc.aspect_ratio)
        to, tcams, tbg = _mixed(TB, tmake_camera, tc.aspect_ratio)
    else:
        jo, jcams, jbg = JS.wavefront_cow_obj(jc.aspect_ratio)
        to, tcams, tbg = TS.wavefront_cow_obj(tc.aspect_ratio)
    js, jst = JB.build_scene(jo, background=jbg, seed=3, bvh=True)
    ts, tst = TB.build_scene(to, background=tbg, seed=3, bvh=True)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.triangle_bvh and tst.sphere_bvh
    assert set(TI.hit_routes(ts, tst, tc, "cpu").values()) <= {"tree",
                                                               "plain"}
    n = jc.n_rays
    o, d, tm, rid = JI._pixel_rays(jcams[0], jc, jnp.arange(n, dtype=jnp.int32),
                                   jnp.uint32(3))
    with jax.disable_jit(op_by_op):
        ref, ref_seg = JI.trace_rays(js, jst, jc, o, d, tm, rid,
                                     jnp.uint32(3), return_stats=True)
    o, d, tm, rid = TI._pixel_rays(tcams[0], tc, torch.arange(n), 3)
    got, seg = TI.trace_rays(ts, tst, tc, o, d, tm, rid, 3,
                             return_stats=True)
    dseg, bad, mean = _flips(got.numpy(), np.asarray(ref), seg, ref_seg)
    assert int(seg) > n
    assert dseg <= max(2, n // 500)
    assert bad <= max(2, n // 500)
    assert mean < 1e-4


# ---- dispatch, tables and the scene's leaves -----------------------------------

def test_hit_routes_and_tables():
    """Which closest hit each family takes: the JAX selection (kernels for
    use_pallas True, the plain traverse with a tree and the brute force
    without one on the CPU or with use_pallas False), and on a card under
    "auto" the BVH kernel for every family with a tree, however small (a
    tree below the builder's thresholds comes from bvh=True). No kernel
    table is built on the CPU."""
    ts, tst, _ = TS.generate_scene("wavefront_cow_obj", ASPECT, device="cpu")
    auto, off, on = (TConfig(use_pallas=u) for u in ("auto", False, True))
    assert TI.hit_routes(ts, tst, auto, "cpu") == dict(
        spheres="plain", rects="plain", triangles="tree")
    assert TI.hit_routes(ts, tst, off, "cuda") == dict(
        spheres="plain", rects="plain", triangles="tree")
    assert TI.hit_routes(ts, tst, on, "cpu") == dict(
        spheres="kernel", rects="kernel", triangles="kernel")
    assert TI.hit_routes(ts, tst, auto, "cuda") == dict(
        spheres="kernel", rects="kernel", triangles="bvh")
    assert TI.hit_routes(ts, tst, on, "cuda") == dict(
        spheres="kernel", rects="kernel", triangles="kernel")
    bare = ts._replace(triangle_bvh=None)
    assert TI.hit_routes(bare, tst, auto, "cpu")["triangles"] == "plain"
    assert TI.hit_routes(bare, tst, auto, "cuda")["triangles"] == "kernel"
    assert TI.kernel_tables(ts, tst, auto, "cpu") is None
    assert TI.kernel_tables(ts, tst, on, "cpu") is None
    tabs = TI.kernel_tables(ts, tst, auto, "cuda")   # as on a card
    assert tabs[1] is not None and tabs[0] is not None
    assert isinstance(tabs[2], BT.Tables)
    assert tabs[2].nodes.shape == (2 * tst.n_triangles - 1, 8)
    objs, _, bg = TS.jumpy_balls(ASPECT)
    small, sst = TB.build_scene(objs, background=bg, bvh=True)
    assert sst.sphere_bvh and sst.n_spheres < 513
    assert TI.hit_routes(small, sst, auto, "cuda")["spheres"] == "bvh"
    assert TI.hit_routes(small, sst, auto, "cpu")["spheres"] == "tree"


def test_kernel_tables_layout(rng):
    """The BVH kernel's packed nodes carry bmin, bmax and the int32 bits of
    prim and skip; its triangle rows the plain leaf test's v0, valid, ab,
    ac and n; its sphere rows are K10's table."""
    scene, _ = TB.build_scene(_tri_objs(TB, rng, 90)
                              + _sphere_objs(TB, rng, 520), bvh=True)
    tree = scene.triangle_bvh
    nodes = BT.node_table(tree)
    cols = dict(zip(BT.NODE_ROWS, nodes.unbind(1)))
    assert nodes.shape == (tree.prim.shape[0], 8) and nodes.is_contiguous()
    for i, a in enumerate("xyz"):
        assert torch.equal(cols[f"bmin{a}"], tree.bmin[:, i])
        assert torch.equal(cols[f"bmax{a}"], tree.bmax[:, i])
    assert torch.equal(cols["prim"].contiguous().view(torch.int32), tree.prim)
    assert torch.equal(cols["skip"].contiguous().view(torch.int32), tree.skip)
    rows = BT.triangle_rows(scene.triangles)
    assert rows.shape == (scene.triangles.v0.shape[0],
                          len(BT.TRIANGLE_ROWS)) == (90, 16)
    ab, ac, n = tbvh.triangle_edges(scene.triangles)
    assert torch.equal(rows[:, 0:3], scene.triangles.v0)
    assert torch.equal(rows[:, 3], scene.triangles.valid.float())
    for k, want in ((4, ab), (8, ac), (12, n)):
        assert torch.equal(rows[:, k:k + 3], want)
        assert not rows[:, k + 3].any()
    tabs = BT.tables("spheres", scene.sphere_bvh, scene.spheres)
    assert torch.equal(tabs.rows, SI.sphere_table(scene.spheres))


def test_scene_leaves_with_trees():
    """leaves() ends with the trees' bmin, bmax, prim, skip (sphere tree,
    then triangle tree: JAX's tree_leaves order); from_leaves reads them
    back with the scene's `trees` and raises on leaves that do not make
    those trees; .to moves the trees."""
    ts, tst, _ = TS.generate_scene("wavefront_cow_obj", ASPECT, device="cpu")
    js, _, _ = JS.generate_scene("wavefront_cow_obj", ASPECT)
    leaves = ts.leaves()
    jleaves = jtu.tree_leaves(js)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape and str(a.dtype).split(".")[1] == str(
            b.dtype)
    assert leaves[-4] is ts.triangle_bvh.bmin
    assert ts.trees == (False, True)
    for wrong in ((False, False), (True, True)):
        with pytest.raises(ValueError, match="trees"):
            SceneData.from_leaves(leaves, wrong)
    back = SceneData.from_leaves(leaves, ts.trees)
    assert back.sphere_bvh is None
    assert all(a is b for a, b in zip(back.triangle_bvh, ts.triangle_bvh))
    moved = ts.to("cpu")
    assert moved.triangle_bvh.skip.device.type == "cpu"
    none = ts._replace(triangle_bvh=None)
    assert SceneData.from_leaves(none.leaves()).triangle_bvh is None
    grads, _ = convert.grads_from_numpy(
        ts, [np.zeros(x.shape, np.float32) for x in jleaves
             if jnp.issubdtype(x.dtype, jnp.floating)])
    assert torch.equal(grads.triangle_bvh.bmin,
                       torch.zeros_like(ts.triangle_bvh.bmin))
    assert grads.triangle_bvh.prim is None
