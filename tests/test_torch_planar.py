"""The port's planar family (rects, cuboids, triangles, meshes) against the JAX package.

Small sizes (16x16, 4 spp, depth 5, seed 3; n = 1024 lanes) and the JAX side
run as its own tests run it: staged jnp (`trace_rays`), `render_fused(
interpret=True)` and `replay_bwd_fused(interpret=True)`; the differentiable
render and inverse rendering are in tests/test_torch_planar_diff.py. Both
packages build every scene with `bvh=False` (the cow would get a tree):
the trees are tests/test_torch_bvh.py's. Scenes: cornell_box (rects + rotated cuboids lowered to triangles),
mesh_shards (40 triangles with random vertex normals between two rects, the
smooth-normal mesh of tests/test_megakernel.py:151-166), rect_room (spheres
and rects in one launch, tests/test_megakernel.py:260-283), uv_shards
(mesh_shards with uv-debug textures: the only scenes whose radiance moves
continuously with the geometry), simple_triangle and the cow.

Flip budgets are those of tests/test_megakernel.py:119-128 for planar
scenes: the kernel's affine plane test and the staged (k - o_f)/d_f and
scalar-triple forms round differently on wall corners and cuboid edges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu.camera import make_camera as jmake_camera
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops import rect as jrect
from raytracer_weekend_tpu.ops import triangle as jtri
from raytracer_weekend_tpu.ops.pallas import replay_bwd as JRB
from raytracer_weekend_tpu.ops.pallas.megakernel import render_fused as jax_render_fused
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch.camera import make_camera as tmake_camera
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops import rect as trect
from raytracer_weekend_tpu_torch.ops import triangle as ttri
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as RB
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import convert, objloader
from raytracer_weekend_tpu_torch.scene.data import SceneData

SIZE = dict(width=16, height=16, samples_per_pixel=4, max_depth=5, seed=3)
SEED = 3


def _shards(B, make_camera, aspect, uv=False):
    """mesh_shards (models/scenes.py) on either builder; with `uv` the
    floor and the Lambertian shards wear the uv-debug texture."""
    rng = np.random.default_rng(42)
    floor = B.Lambertian(B.UVDebug() if uv else (0.6, 0.6, 0.6))
    objs = [B.XZRectangle(-6, 6, -6, 6, -1.2, floor),
            B.XZRectangle(-2, 2, -2, 2, 4.0, B.DiffuseLight((4, 4, 4)))]
    mats = [B.Lambertian(B.UVDebug() if uv else (0.8, 0.3, 0.3)),
            B.Metal((0.9, 0.9, 0.9), 0.05)]
    for i in range(40):
        v = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
        n = rng.normal(size=(3, 3)).astype(np.float32) * 1.5
        objs.append(B.Triangle(
            tuple(tuple(float(c) for c in x) for x in v), mats[i % 2],
            normals=tuple(tuple(float(c) for c in x) for x in n)))
    cam = make_camera(look_from=(0, 1, -8), look_at=(0, 0, 0),
                      up_vector=(0, 1, 0), vertical_field_of_view=45.0,
                      aspect_ratio=aspect, aperture=0.0, focus_dist=8.0,
                      time0=0.0, time1=1.0)
    return objs, [cam], (0.05, 0.05, 0.08)


def _rect_room(B, make_camera, aspect):
    """Spheres and rects in one launch (tests/test_megakernel.py:260-283)."""
    red = B.Lambertian((0.65, 0.05, 0.05))
    white = B.Lambertian((0.73, 0.73, 0.73))
    green = B.Lambertian((0.12, 0.45, 0.15))
    light = B.DiffuseLight((15.0, 15.0, 15.0))
    objs = [B.YZRectangle(0, 555, 0, 555, 555, green),
            B.YZRectangle(0, 555, 0, 555, 0, red),
            B.XZRectangle(213, 343, 227, 332, 554, light),
            B.XZRectangle(0, 555, 0, 555, 0, white),
            B.XZRectangle(0, 555, 0, 555, 555, white),
            B.XYRectangle(0, 555, 0, 555, 555, white),
            B.Sphere((190, 90, 190), 90, B.Dielectric(1.5)),
            B.Sphere((370, 120, 350), 120, B.Metal((0.8, 0.85, 0.88), 0.1))]
    cam = make_camera(look_from=(278, 278, -800), look_at=(278, 278, 0),
                      up_vector=(0, 1, 0), vertical_field_of_view=40.0,
                      aspect_ratio=aspect, aperture=0.0, focus_dist=10.0,
                      time0=0.0, time1=1.0)
    return objs, [cam], (0.0, 0.0, 0.0)


_TEST_SCENES = {
    "mesh_shards": _shards,
    "uv_shards": lambda B, mc, a: _shards(B, mc, a, uv=True),
    "rect_room": _rect_room,
}


def _scenes(name, **size):
    """((jax scene, static, cfg, cam), (port scene, static, cfg, cam))."""
    kw = {**SIZE, **size}
    jc, tc = JConfig(use_pallas=False, **kw), TConfig(**kw)
    if name in _TEST_SCENES:
        jo, jcams, jbg = _TEST_SCENES[name](JB, jmake_camera, jc.aspect_ratio)
        to, tcams, tbg = _TEST_SCENES[name](TB, tmake_camera, tc.aspect_ratio)
    else:
        jo, jcams, jbg = getattr(JS, name)(jc.aspect_ratio, seed=0)
        to, tcams, tbg = getattr(TS, name)(tc.aspect_ratio, seed=0)
    js, jst = JB.build_scene(jo, background=jbg, seed=jc.seed, bvh=False)
    ts, tst = TB.build_scene(to, background=tbg, seed=tc.seed, bvh=False)
    return (js, jst, jc, jcams[0]), (ts, tst, tc, tcams[0])


def _flips(got, ref, got_seg, ref_seg):
    """(|segment delta|, lanes with rel err > 0.05, mean abs err)."""
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-3)
    bad = len(np.unique(np.argwhere(rel > 0.05)[:, 0]))
    return abs(int(got_seg) - int(ref_seg)), bad, float(np.abs(got - ref).mean())


# ---- 1. builder tables -----------------------------------------------------

@pytest.mark.parametrize("name", ["cornell_box", "simple_triangle",
                                  "wavefront_cow_obj", "mesh_shards"])
def test_builder_tables_bit_equal(name):
    """Rects, cuboids (rotated: 2 triangles per side), flat and smooth
    triangles and the OBJ cow: bit-equal tables, Morton order included."""
    (js, jst, _, _), (ts, tst, _, _) = _scenes(name)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.fused_simple and not (tst.sphere_bvh or tst.triangle_bvh)
    for fam in ("spheres", "rects", "triangles", "volumes", "materials",
                "textures"):
        jt, tt = getattr(js, fam), getattr(ts, fam)
        assert tt._fields == jt._fields
        for f in jt._fields:
            want = np.asarray(getattr(jt, f))
            got = getattr(tt, f).numpy()
            assert got.dtype == want.dtype, (fam, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{fam}.{f}")
    np.testing.assert_array_equal(ts.background.numpy(),
                                  np.asarray(js.background))
    counts = dict(cornell_box=(0, 6, 24), simple_triangle=(1, 0, 1),
                  wavefront_cow_obj=(1, 1, 5804), mesh_shards=(0, 2, 40))
    assert (tst.n_spheres, tst.n_rects, tst.n_triangles) == counts[name]
    assert tst.has_uvdebug == (name == "simple_triangle")
    if name == "cornell_box":   # the JAX scene crosses over leaf by leaf
        back = convert.scene_from_numpy(jtu.tree_map(np.asarray, js))
        for a, b in zip(back.leaves(), ts.leaves()):
            assert torch.equal(a, b)


def test_objloader_diffuse_maps(tmp_path):
    """A readable map_Kd builds Lambertian(ImageTexture), as the JAX loader
    does; the fallback stands in, with a warning, for a map that cannot be
    read or decoded, and without it such a map raises."""
    from PIL import Image

    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl tex\nf 1 2 4 3\n")
    (tmp_path / "m.mtl").write_text("newmtl tex\nillum 1\nmap_Kd t.png\n")
    with pytest.raises(FileNotFoundError):
        objloader.load_wavefront_obj(str(tmp_path / "m.obj"))
    with pytest.warns(UserWarning, match="unreadable"):
        tris = objloader.load_wavefront_obj(str(tmp_path / "m.obj"),
                                            missing_texture_fallback=(.6,) * 3)
    assert len(tris) == 2 and tris[0].material is tris[1].material
    assert tris[0].material.albedo == TB.SolidColor((.6, .6, .6))
    (tmp_path / "t.png").write_bytes(b"\x89PNG")      # not decodable
    with pytest.warns(UserWarning, match="unreadable"):
        tris = objloader.load_wavefront_obj(str(tmp_path / "m.obj"),
                                            missing_texture_fallback=(.6,) * 3)
    assert tris[0].material.albedo == TB.SolidColor((.6, .6, .6))
    texels = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3) * 10
    Image.fromarray(texels).save(tmp_path / "t.png")
    tris = objloader.load_wavefront_obj(str(tmp_path / "m.obj"),
                                        missing_texture_fallback=(.6,) * 3)
    tex = tris[0].material.albedo
    assert isinstance(tex, TB.ImageTexture)
    np.testing.assert_array_equal(tex.data, texels.astype(np.float32) / 255.0)


# ---- 2. staged hit kernels and hit records ---------------------------------

@pytest.mark.parametrize("name,family", [("cornell_box", "rects"),
                                         ("cornell_box", "triangles"),
                                         ("mesh_shards", "triangles")])
def test_hit_and_record_match(name, family):
    """Camera rays (32x32, 1 spp), fed to both as numpy. t and the records
    to 1e-6 relative (of each quantity's largest magnitude): the same f32
    formulas, summed in another order by torch's and XLA's matmuls."""
    j, t = _scenes(name, width=32, height=32, samples_per_pixel=1)
    n = j[2].n_rays
    o, d, _, _ = map(np.asarray, JI._pixel_rays(
        j[3], j[2], jnp.arange(n, dtype=jnp.int32), jnp.uint32(SEED)))
    jtab, ttab = getattr(j[0], family), getattr(t[0], family)
    jhit, jrec = ((jrect.hit_rects, jrect.rect_record) if family == "rects"
                  else (jtri.hit_triangles, jtri.triangle_record))
    thit, trec = ((trect.hit_rects, trect.rect_record) if family == "rects"
                  else (ttri.hit_triangles, ttri.triangle_record))
    tj, ij = map(np.asarray, jhit(jtab, jnp.asarray(o), jnp.asarray(d), 1e-3))
    to_, do_ = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
    tt, it = thit(ttab, to_, do_, 1e-3)
    fin = np.isfinite(tj)
    assert fin.mean() > 0.1
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), fin)
    np.testing.assert_allclose(tt.numpy()[fin], tj[fin], rtol=1e-6)
    same = fin & (it.numpy() == ij)
    assert same.sum() >= fin.sum() - max(1, fin.sum() // 1000)
    idx = np.where(same, ij, 0)
    tsafe = np.where(fin, tj, 0.0).astype(np.float32)
    want = jrec(jtab, jnp.asarray(idx), jnp.asarray(o), jnp.asarray(d),
                jnp.asarray(tsafe))
    got = trec(ttab, torch.from_numpy(idx), to_, do_, torch.from_numpy(tsafe))
    for g, w in zip(got, want):
        g, w = g.numpy()[same], np.asarray(w)[same]
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * max(np.abs(w).max(), 1.0))
        else:
            np.testing.assert_array_equal(g, w)


# ---- 3. the staged path ----------------------------------------------------

@pytest.mark.parametrize("name", ["cornell_box", "mesh_shards"])
def test_trace_rays_matches_staged(name):
    """The port's staged trace against the JAX staged trace (compiled)."""
    j, t = _scenes(name)
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = jc.n_rays
    o, d, tm, rid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                   jnp.uint32(SEED))
    ref, ref_seg = JI.trace_rays(js, jst, jc, o, d, tm, rid, jnp.uint32(SEED),
                                 return_stats=True)
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), SEED)
    got, seg = TI.trace_rays(ts, tst, tc, o, d, tm, rid, SEED,
                             return_stats=True)
    dseg, bad, mean = _flips(got.numpy(), np.asarray(ref), seg, ref_seg)
    # Measured: 0 segments, 0 lanes, mean 0 on both.
    assert dseg <= max(2, n // 500)
    assert bad <= max(2, n // 500)
    assert mean < 1e-4


# ---- 4. codes, replay and the replay backward against the JAX kernels ------

@pytest.fixture(scope="module", params=["cornell_box", "mesh_shards",
                                        "rect_room"])
def fused(request):
    """(name, jax side, port side, JAX fused forward (rad, seg, int codes))."""
    j, t = _scenes(request.param)
    js, jst, jc, jcam = j
    rad, seg, codes = jax_render_fused(js, jc, jcam, 0, jc.n_rays,
                                       jnp.uint32(SEED), interpret=True,
                                       static=jst, emit_paths=True)
    codes = np.asarray(codes)
    codes_i = codes.astype(np.int32)
    np.testing.assert_array_equal(codes_i.astype(np.float32), codes)
    return request.param, j, t, (np.asarray(rad), np.asarray(seg), codes_i)


def test_codes_match_jax(fused):
    """The plain version's codes against JAX K1/K3 with emit_paths, within
    n//100 lanes; planar codes name the unified index (rects first).

    Measured: cornell_box 3 lanes (cuboid edges), mesh_shards 0, rect_room
    11. rect_room's two spheres rest on the floor, tangent to it, and its
    flips are sphere-vs-floor choices at the contact points (radiance
    differs on 0 lanes), so a scene with spheres keeps the sphere budget of
    tests/test_megakernel.py:66-70, n//64."""
    name, j, t, (jrad, jseg, jcodes) = fused
    ts, tst, tc, tcam = t
    n = tc.n_rays
    rad, seg, codes = mk.render_fused(ts, tc, tcam, 0, n, SEED, static=tst,
                                      emit_paths=True)
    rad0, seg0 = mk.render_fused(ts, tc, tcam, 0, n, SEED, static=tst)
    assert torch.equal(rad, rad0) and torch.equal(seg, seg0)
    codes = codes.numpy()
    planar = codes[(codes & 3) == 2] >> 2
    assert planar.size and planar.max() < tst.n_rects + tst.n_triangles
    differ = int((codes != jcodes).any(axis=1).sum())
    assert differ <= max(4, n // 64 if tst.n_spheres else n // 100)
    dseg, bad, mean = _flips(rad.numpy(), jrad, seg.sum(), jseg.sum())
    assert dseg <= max(4, n // 200) and bad <= max(4, n // 100)
    assert mean < 1e-3


def test_replay_matches_jax(fused):
    """replay_rays on JAX's codes against JAX's replay_rays, to 1e-5."""
    name, j, t, (jrad, jseg, jcodes) = fused
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = tc.n_rays
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), SEED)
    got = TI.replay_rays(ts, tst, tc, o, d, tm, rid, SEED,
                         torch.from_numpy(jcodes)).numpy()
    jo, jd, jt, jrid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                      jnp.uint32(SEED))
    want = np.asarray(JI.replay_rays(js, jst, jc, jo, jd, jt, jrid,
                                     jnp.uint32(SEED), jnp.asarray(jcodes)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_replay_bwd_reference_matches_jax_kernel(fused):
    """replay_bwd_reference against JAX replay_bwd_fused(interpret=True),
    both on JAX's codes, g = 2 rad, every output to 2e-5 of its scale;
    the table cotangents also mapped to the scene leaves by each package's
    own pack_ktab/pack_ptab."""
    name, j, t, (jrad, jseg, jcodes) = fused
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = tc.n_rays
    seed = jnp.uint32(SEED)
    jo, jd, jt, jrid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                      seed)
    g = 2.0 * jrad
    jk = JRB.pack_ktab(js) if jst.n_spheres else None
    jp = JRB.pack_ptab(js, jst)
    jout = JRB.replay_bwd_fused(jk, jp, js.background, jc, jo, jd, jt, jrid,
                                seed, jnp.asarray(jcodes, jnp.float32),
                                jnp.asarray(g), n, interpret=True)

    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), SEED)
    leaves = [le.detach().clone() for le in ts.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    scene = SceneData.from_leaves(leaves)
    ktab = RB.pack_ktab(scene) if tst.n_spheres else None
    ptab = RB.pack_ptab(scene, tst)
    np.testing.assert_array_equal(ptab.detach().numpy(), np.asarray(jp))
    out = RB.replay_bwd_fused(ktab, ptab, ts.background, tc, o, d, tm, rid,
                              SEED, torch.from_numpy(jcodes),
                              torch.from_numpy(g), n)

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max() if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=max(scale, 1.0) * 2e-5)

    for k, (got, want) in enumerate(zip(out, jout)):
        assert (got is None) == (want is None)
        if got is not None:
            close(got.numpy(), np.asarray(want)[:RB.KT] if k == 0 else want)
    assert out[1].abs().max() > 0
    # A black background (cornell_box, rect_room) has a zero cotangent: an
    # escaping lane never met the light, so its radiance and g are 0.
    assert bool(out[5].abs().max() > 0) == bool(ts.background.any())

    tabs = [(tb, out[i]) for i, tb in enumerate((ktab, ptab))
            if tb is not None]
    got = torch.autograd.grad([tb for tb, _ in tabs], floats,
                              grad_outputs=[c for _, c in tabs],
                              allow_unused=True)
    got = [torch.zeros_like(le) if gr is None else gr
           for gr, le in zip(got, floats)]

    def pack(sc):
        return (JRB.pack_ktab(sc) if jst.n_spheres else None,
                JRB.pack_ptab(sc, jst))

    _, vjp = jax.vjp(pack, js)
    want_tree = vjp((jout[0], jout[1]))[0]
    want = [np.asarray(le) for le in jtu.tree_leaves(want_tree)
            if le.dtype != jax.dtypes.float0]
    want_scene, _ = convert.grads_from_numpy(ts, want)
    got_scene, _ = convert.grads_from_numpy(ts, [gr.numpy() for gr in got])
    for w, gr in zip(want_scene.leaves(), got_scene.leaves()):
        if w is not None:
            close(gr.numpy(), w.numpy())
