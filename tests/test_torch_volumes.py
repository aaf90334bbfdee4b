"""The port's constant-density media (volumes) against the JAX package.

`ops/volume.py` function by function on random rays; the builder's tables
of the medium scenes bit for bit (cases of tests/test_torch_scene.py
`test_builder_tables_bit_equal`) and animated_book2's 30 cameras; the
staged render with media against JAX `trace_rays` (staged jnp, compiled)
with the budgets of tests/test_megakernel.py:214-258 (smokey_cornell_box,
the sphere-boundary medium scene) and :359-381 (book2); the replay against
the plain fused forward; and `render_fused_diff`'s gradients (the plain
forward with codes, then torch autograd of the replay: the route of every
medium scene, on the card as on the CPU) leaf by leaf against `jax.vjp` of
JAX `replay_rays` on the same codes, with a finite difference on a medium's
albedo as anchor. Both packages build every scene with `bvh=False`
(book2's 1,006 spheres would get a tree under "auto": the trees are
tests/test_torch_bvh.py's).
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
from raytracer_weekend_tpu.ops import volume as jvol
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu_torch import fused_diff, replay
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops import volume as tvol
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene.data import SceneData


def _jax_sphere_medium(aspect):
    """tests/test_megakernel.py:228-258's medium scene on the JAX builder:
    the port's `models.scenes.sphere_medium`."""
    objs = [
        JB.XZRectangle(-6, 6, -6, 6, -1.5, JB.Lambertian((0.5, 0.5, 0.5))),
        JB.XZRectangle(-2, 2, -2, 2, 5.0, JB.DiffuseLight((5, 5, 5))),
        JB.ConstantMedium(JB.Sphere((0.0, 0.0, 0.0), 1.2,
                                    JB.Lambertian((1, 1, 1))),
                          density=0.6, texture=JB.SolidColor((0.2, 0.4, 0.9))),
        JB.Sphere((2.5, 0.0, 0.5), 0.8, JB.Lambertian((0.8, 0.2, 0.2))),
    ]
    cam = jmake_camera(look_from=(0, 1, -7), look_at=(0, 0, 0),
                       up_vector=(0, 1, 0), vertical_field_of_view=40.0,
                       aspect_ratio=aspect, aperture=0.0, focus_dist=7.0,
                       time0=0.0, time1=1.0)
    return objs, [cam], (0.02, 0.02, 0.03)


def _scenes(name, **size):
    """((jax scene, static, cfg, cam), (port scene, static, cfg, cam))."""
    jc, tc = JConfig(use_pallas=False, **size), TConfig(**size)
    if name == "sphere_medium":
        jo, jcams, jbg = _jax_sphere_medium(jc.aspect_ratio)
    else:
        jo, jcams, jbg = getattr(JS, name)(jc.aspect_ratio, seed=0)
    to, tcams, tbg = getattr(TS, name)(tc.aspect_ratio, seed=0)
    js, jst = JB.build_scene(jo, background=jbg, seed=jc.seed, bvh=False)
    ts, tst = TB.build_scene(to, background=tbg, seed=tc.seed, bvh=False)
    return (js, jst, jc, jcams[0]), (ts, tst, tc, tcams[0])


# ---- 1. ops/volume.py ---------------------------------------------------------

def _random_media(B):
    """Sphere and box boundaries, rotated and translated, on either
    builder; the JAX builder's table is the port's (checked below)."""
    white = B.Lambertian((1, 1, 1))
    return [
        B.ConstantMedium(B.Sphere((0.5, -0.2, 0.3), 1.3, white), 0.7,
                         B.SolidColor((0.2, 0.4, 0.9))),
        B.ConstantMedium(B.Cuboid((-1, -0.5, -0.8), (0.6, 1.2, 0.9), white)
                         .rotate_y(33.0).translate((0.4, 0.1, -0.3)), 1.9,
                         B.SolidColor((0.9, 0.9, 0.9))),
        B.ConstantMedium(B.Sphere((2, 0, 0), 0.8, white)
                         .translate((-0.5, 0.5, 0)), 0.05,
                         B.SolidColor((1, 0, 0))).rotate_y(-20.0),
        B.ConstantMedium(B.Cuboid((0, 0, 0), (1, 1, 1), white)
                         .translate((-2.5, -0.5, 0.2)), 3.0,
                         B.SolidColor((0, 1, 0))),
    ]


@pytest.fixture(scope="module")
def media():
    js, _ = JB.build_scene(_random_media(JB), bvh=False)
    ts, _ = TB.build_scene(_random_media(TB), bvh=False)
    for f in js.volumes._fields:
        np.testing.assert_array_equal(getattr(ts.volumes, f).numpy(),
                                      np.asarray(getattr(js.volumes, f)))
    # The last row invalid: it never scatters.
    valid = np.array([True, True, True, False])
    jv = js.volumes._replace(valid=jnp.asarray(valid))
    tv = ts.volumes._replace(valid=torch.from_numpy(valid))
    rng = np.random.default_rng(31)
    n = 4096
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] *= rng.uniform(0.2, 2.0, (n // 2, 1)).astype(np.float32)
    d[:64, 1] = 0.0       # rays parallel to the slabs' y faces
    o[:16, 1] = -0.5      # ... some in the box's bottom plane: 0 * inf
    rid = rng.integers(0, 2**32, n, dtype=np.uint64)
    return jv, tv, o, d, rid


@pytest.mark.parametrize("use_log10", [True, False])
def test_volume_functions_match_jax(media, use_log10):
    """volume_candidates (the +inf pattern equal, finite values within 1e-5
    relative), hit_volumes and volume_record against JAX on 4096 random
    rays, unit and not, some parallel to a slab, through sphere and box
    boundaries, rotated and translated, and an invalid row."""
    jv, tv, o, d, rid = media
    seed, depth = 5, 3
    want = np.asarray(jvol.volume_candidates(
        jv, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.uint32(seed),
        jnp.asarray(rid.astype(np.uint32)), jnp.uint32(depth),
        use_log10=use_log10))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    rt = torch.from_numpy(rid.astype(np.int64))
    got = tvol.volume_candidates(tv, ot, dt, 1e-3, seed, rt, depth,
                                 use_log10=use_log10).numpy()
    assert got.shape == (o.shape[0], 4)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isfinite(want).sum() > 300 and not np.isfinite(want[:, 3]).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)

    jt, ji = jvol.hit_volumes(jv, jnp.asarray(o), jnp.asarray(d), 1e-3,
                              jnp.uint32(seed),
                              jnp.asarray(rid.astype(np.uint32)),
                              jnp.uint32(depth), use_log10=use_log10)
    tt, ti = tvol.hit_volumes(tv, ot, dt, 1e-3, seed, rt, depth,
                              use_log10=use_log10)
    fin = np.isfinite(np.asarray(jt))
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), fin)
    np.testing.assert_array_equal(ti.numpy()[fin], np.asarray(ji)[fin])
    np.testing.assert_allclose(tt.numpy()[fin], np.asarray(jt)[fin],
                               rtol=1e-5)

    t_rec = np.where(fin, np.asarray(jt), 0.0).astype(np.float32)
    jrec = jvol.volume_record(jv, ji, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_rec))
    trec = tvol.volume_record(tv, ti, ot, dt, torch.from_numpy(t_rec))
    for a, b in zip(trec, jrec):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_volume_candidates_grad_finite_on_parallel_rays(media):
    """Rays with a direction component exactly 0 (parallel to a box's
    slabs; a Lambertian bounce off an axis-aligned wall draws one now and
    then) and some from a slab's own plane (0 * inf): the candidates are
    JAX's, and their gradients with respect to the rays and the media are
    finite, where 1/d's derivative at 0 would make them NaN."""
    jv, tv, o, d, rid = media
    o, d, rid = o[:64], d[:64], rid[:64]
    assert (d[:, 1] == 0).all()
    want = np.asarray(jvol.volume_candidates(
        jv, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.uint32(5),
        jnp.asarray(rid.astype(np.uint32)), jnp.uint32(3)))
    ot = torch.from_numpy(o).requires_grad_()
    dt = torch.from_numpy(d).requires_grad_()
    lo = tv.bmin.clone().requires_grad_()
    got = tvol.volume_candidates(tv._replace(bmin=lo), ot, dt, 1e-3, 5,
                                 torch.from_numpy(rid.astype(np.int64)), 3)
    np.testing.assert_array_equal(np.isinf(got.detach().numpy()),
                                  np.isinf(want))
    fin = torch.isfinite(got)
    assert int(fin.sum()) > 5
    grads = torch.autograd.grad(torch.where(fin, got, 0.0).sum(),
                                (ot, dt, lo))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().max()) > 0


def test_animated_book2_cameras_match():
    """The 30 dolly cameras of animated_book2_final_scene (aperture 1)."""
    _, jcams, _ = JS.animated_book2_final(16 / 9, seed=0)
    _, tcams, _ = TS.animated_book2_final(16 / 9, seed=0)
    assert len(tcams) == len(jcams) == 30
    for j, t in zip(jcams, tcams):
        for f in Camera._fields:
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)), rtol=1e-6,
                                       atol=1e-5)
    assert "animated_book2_final_scene" in TS.SCENES


# ---- 2. the staged render against JAX trace_rays -----------------------------

def _trace_both(j, t):
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n, seed = tc.n_rays, tc.seed
    o, d, tm, rid = JI._pixel_rays(jcam, jc, jnp.arange(n), seed)
    want, wseg = JI.trace_rays(js, jst, jc, o, d, tm, rid, seed,
                               return_stats=True)
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), seed)
    got, seg = TI.trace_lanes(ts, tst, tc, o, d, tm, rid, seed)
    return np.asarray(want), int(wseg), got.numpy(), int(seg.sum()), n


@pytest.mark.parametrize("name, size, budgets", [
    ("smokey_cornell_box", dict(width=24, height=24, samples_per_pixel=4,
                                max_depth=6, seed=19), (200, 100, 1e-3)),
    ("sphere_medium", dict(width=24, height=24, samples_per_pixel=4,
                          max_depth=6, seed=23), (200, 100, 1e-3)),
    ("book2_final_scene", dict(width=20, height=20, samples_per_pixel=2,
                               max_depth=6, seed=3), (20, 100, 2e-2)),
])
def test_staged_render_matches_jax(name, size, budgets):
    """The staged path with media against JAX's, compiled (which flips a
    few lanes against the same path run op by op: with JAX run op by op the
    radiance is identical on all three scenes). Budgets: segments
    n // seg, lanes off by more than 5% n // bad, mean abs error."""
    seg_b, bad_b, mean_b = budgets
    want, wseg, got, seg, n = _trace_both(*_scenes(name, **size))
    assert np.isfinite(got).all() and float(got.max()) > 0
    assert abs(seg - wseg) <= max(4, n // seg_b)
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert (rel > 0.05).any(axis=1).sum() <= max(4, n // bad_b)
    assert np.abs(got - want).mean() < mean_b


def test_render_fused_plain_codes_name_media():
    """The plain fused render's codes (3 + 4v for medium v) and its radiance
    equal the staged path's; both smoke boxes scatter some lanes."""
    _, t = _scenes("smokey_cornell_box", width=24, height=24,
                   samples_per_pixel=4, max_depth=6, seed=19)
    ts, tst, tc, tcam = t
    assert mk.fused_supported(tst, tc)
    rad, seg, codes = mk.render_fused(ts, tc, tcam, 0, tc.n_rays, tc.seed,
                                      static=tst, emit_paths=True)
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(tc.n_rays), tc.seed)
    want, wseg = TI.trace_lanes(ts, tst, tc, o, d, tm, rid, tc.seed)
    assert torch.equal(rad, want) and torch.equal(seg, wseg)
    vol = codes[(codes & 3) == 3] >> 2
    assert set(vol.unique().tolist()) == {0, 1}
    nz = (codes > 0).sum(1)
    assert bool(((nz == seg) | (nz == seg - 1)).all())


# ---- 3. the replay and the gradients -----------------------------------------

DIFF = dict(width=24, height=24, samples_per_pixel=4, max_depth=6)


def _forward(t):
    ts, tst, tc, tcam = t
    rad, _, codes = mk.render_fused(ts, tc, tcam, 0, tc.n_rays, tc.seed,
                                    static=tst, emit_paths=True)
    return rad, codes


@pytest.mark.parametrize("name, seed", [("smokey_cornell_box", 19),
                                        ("sphere_medium", 23)])
def test_replay_reproduces_plain_forward(name, seed):
    """replay_rays on the plain forward's codes gives its radiance
    (tests/test_fused_diff.py:35-52's rtol and atol 1e-4)."""
    _, t = _scenes(name, seed=seed, **DIFF)
    ts, tst, tc, tcam = t
    rad, codes = _forward(t)
    assert int(((codes & 3) == 3).sum()) > 100
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(tc.n_rays), tc.seed)
    got = replay.replay_rays(ts, tst, tc, o, d, tm, rid, tc.seed, codes)
    torch.testing.assert_close(got, rad, rtol=1e-4, atol=1e-4)


def _jax_replay_grads(j, t, codes, g):
    """jax.vjp of JAX replay_rays (through _pixel_rays) on the port's codes
    with cotangent g -> (port SceneData of grads, Camera of grads), and
    JAX's replayed radiance."""
    js, jst, jc, jcam = j
    n, seed = jc.n_rays, jc.seed
    jcodes = jnp.asarray(codes.numpy().astype(np.float32))

    def f(sc, cam):
        o, d, tm, rid = JI._pixel_rays(cam, jc, jnp.arange(n), seed)
        return JI.replay_rays(sc, jst, jc, o, d, tm, rid, seed, jcodes)

    rad, vjp = jax.vjp(f, js, jcam)
    gs, gc = vjp(jnp.asarray(g))
    floats = [np.asarray(le) for le in jtu.tree_leaves(gs)
              if le.dtype != jax.dtypes.float0]
    got = convert.grads_from_numpy(t[0], floats,
                                   jtu.tree_map(np.asarray, gc))
    return got, np.asarray(rad)


def _port_grads(t, w):
    """d sum(w * rad^2) through render_fused_diff -> (grads of the scene's
    float leaves as a SceneData, of the camera as a Camera)."""
    ts, tst, tc, tcam = t
    leaves = [le.detach().clone() for le in ts.leaves()]
    cam = Camera(*(c.detach().clone().requires_grad_() for c in tcam))
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    rad = fused_diff.render_fused_diff(SceneData.from_leaves(leaves), tst, tc,
                                       cam, 0, tc.n_rays, tc.seed)
    loss = (w[:, None] * rad * rad).sum()
    grads = torch.autograd.grad(loss, floats + list(cam))
    got, _ = convert.grads_from_numpy(
        ts, [g.numpy() for g in grads[:len(floats)]])
    return got, Camera(*grads[len(floats):]), rad.detach()


@pytest.mark.parametrize("name, seed", [("smokey_cornell_box", 19),
                                        ("sphere_medium", 23)])
def test_fused_diff_grads_match_jax_replay(name, seed):
    """Every float leaf of scene and camera: render_fused_diff (the plain
    forward with codes, autograd of the port's replay) against jax.vjp of
    JAX replay_rays on the same codes with the same cotangent 2 w rad. A
    lane whose replay in either package does not reproduce the forward's
    radiance (1e-4) is weighed out: it would differentiate another path.
    Budgets norm_rel <= 1e-4 and cos >= 0.9999 per live leaf; the media's
    boundaries and densities, like the surfaces' geometry under solid
    textures, get exactly 0 in both packages."""
    j, t = _scenes(name, seed=seed, **DIFF)
    rad, codes = _forward(t)
    ts, tst, tc, tcam = t
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(tc.n_rays), tc.seed)
    mine = replay.replay_rays(ts, tst, tc, o, d, tm, rid, tc.seed, codes)
    _, jrad = _jax_replay_grads(j, t, codes, np.zeros((tc.n_rays, 3),
                                                      np.float32))
    keep = (torch.isclose(mine, rad, rtol=1e-4, atol=1e-4).all(1)
            & torch.isclose(torch.from_numpy(jrad.copy()), rad, rtol=1e-4,
                            atol=1e-4).all(1))
    n = tc.n_rays
    assert int(keep.sum()) >= n - max(4, n // 100)
    w = keep.to(torch.float32)
    got_s, got_c, frad = _port_grads(t, w)
    assert torch.equal(frad, rad)
    (want_s, want_c), _ = _jax_replay_grads(
        j, t, codes, (2.0 * w[:, None] * rad).numpy())
    vol_geom = {"center", "radius", "bmin", "bmax", "cos_t", "sin_t",
                "offset", "neg_inv_density"}
    live = []
    pairs = [(f"{fam}.{f}", getattr(getattr(got_s, fam), f),
              getattr(getattr(want_s, fam), f))
             for fam in ("spheres", "rects", "triangles", "volumes",
                         "materials", "textures")
             for f in getattr(want_s, fam)._fields]
    pairs += [("background", got_s.background, want_s.background)]
    pairs += [(f"cam.{f}", g, r) for f, g, r in
              zip(Camera._fields, got_c, want_c)]
    pairs = [(k, g, r) for k, g, r in pairs if r is not None]
    gscale = max(float(r.abs().max()) for _, _, r in pairs if r.numel())
    for key, g, r in pairs:
        g, r = g.detach().numpy(), r.numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), key
        if key.split(".")[-1] in vol_geom and key.startswith("volumes"):
            assert not g.any() and not r.any(), key
            continue
        if not r.size or float(np.abs(r).max()) <= gscale * 1e-7:
            assert np.abs(g).max() <= max(gscale, 1.0) * 1e-5, key
            continue
        live.append(key)
        na = np.linalg.norm(r)
        assert np.linalg.norm(g - r) / na <= 1e-4, key
        assert float((g * r).sum()) / (na * np.linalg.norm(g)) >= 0.9999, key
    assert "textures.color1" in live, live


def test_medium_albedo_grad_matches_finite_difference():
    """A finite-difference anchor on smokey_cornell_box's white smoke: the
    radiance is a polynomial in a medium's albedo once the paths are fixed
    (no discrete choice reads a color), so the central difference of
    sum(rad^2) is exact up to rounding. The density's and the boundary's
    gradients are exactly 0."""
    _, t = _scenes("smokey_cornell_box", seed=19, **DIFF)
    ts, tst, tc, tcam = t
    tid = int(ts.materials.tex[int(ts.volumes.mat[1])])
    assert ts.textures.color1[tid].tolist() == [1.0, 1.0, 1.0]
    c1 = ts.textures.color1.detach().clone().requires_grad_()
    nid = ts.volumes.neg_inv_density.clone().requires_grad_()
    off = ts.volumes.offset.clone().requires_grad_()
    sc = ts._replace(textures=ts.textures._replace(color1=c1),
                     volumes=ts.volumes._replace(neg_inv_density=nid,
                                                 offset=off))
    rad = fused_diff.render_fused_diff(sc, tst, tc, tcam, 0, tc.n_rays,
                                       tc.seed)
    g_c1, g_nid, g_off = torch.autograd.grad((rad * rad).sum(),
                                             (c1, nid, off))
    assert not g_nid.any() and not g_off.any()

    def loss_at(v):
        col = ts.textures.color1.clone()
        col[tid, 1] = v
        r, _ = mk.render_fused(ts._replace(textures=ts.textures._replace(
            color1=col)), tc, tcam, 0, tc.n_rays, tc.seed, static=tst)
        return float((r.double() ** 2).sum())

    eps = 1e-2
    fd = (loss_at(1.0 + eps) - loss_at(1.0 - eps)) / (2 * eps)
    assert abs(fd) > 0
    assert abs(fd - float(g_c1[tid, 1])) <= 1e-3 * abs(fd)


def test_volume_static_flags():
    """The builder's statics for media: book2 fused_simple with 2 media; a
    medium whose phase texture is not a solid color is outside the fused
    slice, as in JAX."""
    _, t = _scenes("book2_final_scene", width=8, height=8,
                   samples_per_pixel=1, max_depth=2, seed=0)
    assert t[1].n_volumes == 2 and t[1].fused_simple
    objs = [TB.Sphere((0, 0, 0), 1.0, TB.Lambertian((0.5, 0.5, 0.5))),
            TB.ConstantMedium(TB.Sphere((0, 0, 0), 2.0, TB.Dielectric(1.5)),
                              0.5, TB.NoiseTexture(1.0))]
    _, st = TB.build_scene(objs)
    jobjs = [JB.Sphere((0, 0, 0), 1.0, JB.Lambertian((0.5, 0.5, 0.5))),
             JB.ConstantMedium(JB.Sphere((0, 0, 0), 2.0, JB.Dielectric(1.5)),
                               0.5, JB.NoiseTexture(1.0))]
    _, jst = JB.build_scene(jobjs, bvh=False)
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert not st.fused_simple and st.n_volumes == 1
    with pytest.raises(TypeError):
        TB.build_scene([TB.ConstantMedium(TB.XYRectangle(
            0, 1, 0, 1, 0, TB.Lambertian((1, 1, 1))), 1.0, (1, 1, 1))])
