"""The port's deferred-texture fused render and its backward against the JAX package.

Scenes earth, two_perlin_spheres and simple_light. The JAX side runs as its
own tests run it: `render_fused(interpret=True, emit_paths=True,
emit_deferred=True)`, its jnp `_combine_deferred`, `replay_bwd_fused(
interpret=True)` with per-bounce cotangents and `render_fused_diff(
interpret=True)`. Codes convert from JAX's f32 to int32 only at the
comparison. Each package runs its own forward, so a lane whose winner flips
between them (near-tangent hits; the kernel's and the staged arithmetic
round differently) is compared for its radiance within the budgets of
tests/test_megakernel.py:322-328 and weighed out of the gradient
comparison, as tests/test_torch_fused_diff.py does.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.fused_diff import render_fused_diff as jax_render_fused_diff
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops.pallas import replay_bwd as JRB
from raytracer_weekend_tpu.ops.pallas.megakernel import _combine_deferred
from raytracer_weekend_tpu.ops.pallas.megakernel import render_fused as jax_render_fused
from raytracer_weekend_tpu_torch import fused_diff
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as RB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene.data import SceneData

SCENES = ["earth", "two_perlin_spheres", "simple_light"]
FWD = dict(width=24, height=16, samples_per_pixel=4, max_depth=6, seed=3)
DIFF = dict(width=24, height=14, samples_per_pixel=2, max_depth=4, seed=0)


def _pair(name, size):
    jc, tc = JConfig(**size), TConfig(**size)
    js, jst, jcams = JS.generate_scene(name, jc.aspect_ratio)
    ts, tst, tcams = TS.generate_scene(name, tc.aspect_ratio, device="cpu")
    return (js, jst, jc, jcams[0]), (ts, tst, tc, tcams[0])


def _jax_forward(j):
    js, jst, jc, jcam = j
    rad, seg, codes, ctb, dfr = jax_render_fused(
        js, jc, jcam, 0, jc.n_rays, jnp.uint32(jc.seed), interpret=True,
        static=jst, emit_paths=True, emit_deferred=True)
    dfr = np.asarray(dfr)
    dcode = np.round(dfr[..., 3]).astype(np.int32)
    np.testing.assert_array_equal(dcode.astype(np.float32), dfr[..., 3])
    return (np.asarray(rad), np.asarray(seg), np.asarray(codes).astype(np.int32),
            np.asarray(ctb), dfr[..., :3], dcode)


@pytest.fixture(scope="module", params=SCENES)
def fwd(request):
    """(name, jax side, port side, JAX's forward, the port's plain forward)
    at 24x16, 4 spp, depth 6."""
    j, t = _pair(request.param, FWD)
    ts, tst, tc, tcam = t
    got = mk.render_fused(ts, tc, tcam, 0, tc.n_rays, tc.seed, static=tst,
                          emit_paths=True, emit_deferred=True)
    return request.param, j, t, _jax_forward(j), [x.numpy() for x in got]


def test_records_match_jax(fwd):
    """(a) The plain fused render's records and combined radiance (the plain
    version of K6a and the combine) against JAX K6 with its combine."""
    name, j, t, want, got = fwd
    jrad, jseg, jcodes, jctb, jabc, jdcode = want
    rad, seg, codes, ctb, abc, dcode = got
    n, D = codes.shape
    assert ctb.shape == (n, D, 3) and abc.shape == (n, D, 3)
    assert dcode.shape == (n, D) and dcode.dtype == np.int32
    # tests/test_megakernel.py:322-328 budgets on the combined radiance.
    assert abs(int(seg.sum()) - int(jseg.sum())) <= max(4, n // 200)
    rel = np.abs(rad - jrad) / (np.abs(jrad) + 1e-3)
    assert len(np.unique(np.argwhere(rel > 0.05)[:, 0])) <= max(4, n // 100)
    assert np.abs(rad - jrad).mean() < 5e-3
    # Records, on the lanes whose paths agree.
    same = (codes == jcodes).all(axis=1)
    assert same.sum() >= n - max(4, n // 100)
    np.testing.assert_array_equal(dcode[same], jdcode[same])
    live = (dcode != 0) & same[:, None]
    assert live.sum() > n // 4              # the scene defers most hits
    if name == "simple_light":
        assert (dcode < 0).any() and (dcode > 0).any()   # rect and spheres
    # abc: the hit point or normal each forward computed. The plain version
    # is the staged arithmetic, JAX's the kernel's: on the radius-1000
    # ground the staged quadratic cancels (ROADMAP Queue 3), so a few noise
    # hit points differ by up to ~4e-3 relative. Measured: 1 of 1563 (earth),
    # 8 of 3414 (two_perlin_spheres) records beyond 1e-4.
    far = ~np.isclose(abc[live], jabc[live], rtol=1e-4, atol=1e-4).all(-1)
    assert far.sum() <= max(4, int(live.sum()) // 100)
    np.testing.assert_allclose(abc[live], jabc[live], rtol=1e-2, atol=1e-3)
    assert (abc[dcode == 0] == 0).all()
    np.testing.assert_allclose(ctb[same], jctb[same], rtol=1e-4, atol=1e-4)


def test_combine_matches_jax(fwd):
    """(b) The combine alone, on JAX's records: combine_deferred against
    the JAX `_combine_deferred` (jnp turbulence), and for earth the
    single-hit form against the general one."""
    name, j, t, want, _ = fwd
    js, jst, _, _ = j
    ts, tst, _, _ = t
    _, _, _, jctb, jabc, jdcode = want
    dfr = np.concatenate([jabc, jdcode[..., None].astype(np.float32)], -1)
    ref = np.asarray(_combine_deferred(js, jnp.asarray(jctb), jnp.asarray(dfr),
                                       has_noise=jst.has_noise,
                                       has_image=jst.has_image))
    args = (torch.from_numpy(jctb), torch.from_numpy(jabc),
            torch.from_numpy(jdcode))
    got = mk.combine_deferred(ts.textures, *args, has_noise=tst.has_noise,
                              has_image=tst.has_image).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    via = mk.combine(ts, tst, *args).numpy()
    np.testing.assert_allclose(via, ref, rtol=1e-5, atol=1e-5)
    if name == "earth":
        assert tst.defer_single_hit
        single = mk.combine_deferred_single(ts.textures, *args).numpy()
        np.testing.assert_allclose(single, ref, rtol=1e-5, atol=1e-5)


def test_deferred_replay_bwd_matches_jax(fwd):
    """(c) K7's plain version: replay_bwd_reference with per-bounce
    cotangents g (n, D, 3) and the noise hit-point cotangents cabc against
    JAX replay_bwd_fused(interpret=True), both on JAX's codes, random
    cotangents. Every output within norm_rel 5e-3 and cos 0.999 (GRADPARITY's
    metrics, tests/test_torch_fused_diff.py); without cabc (texels only)
    within 2e-5 of the largest entry. The noise geometry chains differ most
    on the radius-1000 ground sphere, whose quadratic the two replays round
    differently: measured norm_rel 1.9e-3 on two_perlin_spheres' d(ktab)
    (its ground column), 2.0e-4 on simple_light's."""
    name, j, t, want, _ = fwd
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    jrad, _, jcodes, jctb, _, _ = want
    n, D = jcodes.shape
    rng = np.random.default_rng(7)
    g = rng.normal(size=(n, D, 3)).astype(np.float32)
    cabc = (rng.normal(size=(n, D, 3)).astype(np.float32)
            if jst.has_noise else None)
    seed = jnp.uint32(jc.seed)
    jo, jd, jt, jrid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                      seed)
    jk = JRB.pack_ktab(js) if jst.n_spheres else None
    jp = JRB.pack_ptab(js, jst) if jst.n_rects + jst.n_triangles else None
    jout = JRB.replay_bwd_fused(
        jk, jp, js.background, jc, jo, jd, jt, jrid, seed,
        jnp.asarray(jcodes, jnp.float32), jnp.asarray(g), n, interpret=True,
        cabc=None if cabc is None else jnp.asarray(cabc))

    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), tc.seed)
    kt = RB.pack_ktab(ts) if tst.n_spheres else None
    pt = RB.pack_ptab(ts, tst) if tst.n_rects + tst.n_triangles else None
    got = RB.replay_bwd_fused(
        kt, pt, ts.background, tc, o, d, tm, rid, tc.seed,
        torch.from_numpy(jcodes), torch.from_numpy(g), n,
        cabc=None if cabc is None else torch.from_numpy(cabc))
    assert RB.LAUNCHES == 0 and RB.DEFER_LAUNCHES == 0   # the plain version
    rows = (RB.KT, RB.KP)
    for k, (a, b) in enumerate(zip(got, jout)):
        if b is None:
            assert a is None
            continue
        a, b = a.numpy(), np.asarray(b)
        if k < 2:
            b = b[:rows[k]]
        assert a.shape == b.shape and np.isfinite(a).all()
        if cabc is None:
            scale = max(float(np.abs(b).max()), 1.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=scale * 2e-5)
        elif np.abs(b).max() > 0:
            nb = np.linalg.norm(b)
            assert np.linalg.norm(a - b) / nb <= 5e-3
            assert float((a * b).sum()) / (nb * np.linalg.norm(a)) >= 0.999
        else:
            assert not a.any()
    d_o = got[2].numpy()
    if jst.has_noise:     # noise records chain into the geometry
        assert np.abs(d_o).max() > 0
    else:                 # image texels: geometry is structurally 0
        assert not d_o.any()


def _agreeing_lanes(j, t):
    """1 where both packages' forwards trace the same path, else 0: the same
    codes and deferred codes, the records' abc within 1e-4 absolute (far
    on the radius-1000 ground a few ulps of a hit point already move the
    marble of frequency 4 * 2^6 and its gradient, and there the staged
    quadratic's hit points differ from the kernel's by up to ~4e-3
    relative), and the radiance within 1e-4, or 1e-3 for noise scenes (the
    marble at hit points that differ by rounding). Measured at 24x14x2 d4:
    1 lane out on earth, 10 on two_perlin_spheres (the budget's edge), 9
    on simple_light."""
    jrad, _, jcodes, _, jabc, jdcode = _jax_forward(j)
    ts, tst, tc, tcam = t
    rad, _, codes, _, abc, dcode = mk.render_fused(
        ts, tc, tcam, 0, tc.n_rays, tc.seed, static=tst, emit_paths=True,
        emit_deferred=True)
    same = (codes.numpy() == jcodes).all(axis=1)
    same &= (dcode.numpy() == jdcode).all(axis=1)
    close = np.isclose(abc.numpy(), jabc, rtol=0, atol=1e-4).all(axis=-1)
    same &= (close | (jdcode == 0)).all(axis=1)
    tol = 1e-3 if tst.has_noise else 1e-4
    same &= np.isclose(rad.numpy(), jrad, rtol=tol, atol=tol).all(axis=1)
    return same.astype(np.float32)


def _port_grads(t, w):
    ts, tst, tc, tcam = t
    leaves = [le.detach().clone() for le in ts.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    rad = fused_diff.render_fused_diff(SceneData.from_leaves(leaves), tst, tc,
                                       tcam, 0, tc.n_rays, tc.seed)
    loss = (torch.from_numpy(w)[:, None] * rad * rad).sum()
    grads = torch.autograd.grad(loss, floats)
    got, _ = convert.grads_from_numpy(ts, [g.numpy() for g in grads])
    return got


def _jax_grads(j, t, w):
    js, jst, jc, jcam = j

    def loss(sc):
        rad = jax_render_fused_diff(sc, jst, jc, jcam, 0, jc.n_rays,
                                    jnp.uint32(jc.seed), interpret=True)
        return jnp.sum(jnp.asarray(w)[:, None] * rad * rad)

    gs = jax.grad(loss, allow_int=True)(js)
    floats = [np.asarray(le) for le in jtu.tree_leaves(gs)
              if le.dtype != jax.dtypes.float0]
    want, _ = convert.grads_from_numpy(t[0], floats)
    return want


@pytest.mark.parametrize("name", SCENES)
def test_fused_diff_grads_match_jax(name):
    """(d) Every float leaf against JAX render_fused_diff(interpret=True) at
    24x14, 2 spp, depth 4, with the tolerances of tests/test_fused_diff.py:
    361-377: atol 6e-2 of the leaf's scale with cos > 0.998 for noise scenes
    (the marble is evaluated at each package's own recorded hit point and
    the turbulence's derivative amplifies their rounding), 5e-5 for image
    scenes."""
    j, t = _pair(name, DIFF)
    w = _agreeing_lanes(j, t)
    n = len(w)
    assert w.sum() >= n - max(4, n // 64)
    got = _port_grads(t, w)
    want = _jax_grads(j, t, w)
    tol = 6e-2 if t[1].has_noise else 5e-5
    live = 0
    for g, r in zip(got.leaves(), want.leaves()):
        if r is None:
            continue
        g, r = g.numpy(), r.numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        if not r.size:
            continue
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=0, atol=max(scale, 1.0) * tol)
        if scale > 0:
            cos = float((g * r).sum()) / (np.linalg.norm(g) * np.linalg.norm(r)
                                          + 1e-30)
            assert cos > 0.998, cos
            live += 1
    # Image scenes: texels and background; noise scenes also sphere
    # geometry, colors, the noise scale and the Perlin table.
    assert live >= (4 if t[1].has_noise else 2), live
    images = got.textures.images.numpy()
    if t[1].has_image:
        assert np.abs(images).max() > 0


def test_texel_grad_matches_finite_difference():
    """A finite-difference anchor on earth: with the paths fixed, every lane's
    radiance is affine in a texel (one deferred record per path), so
    sum(rad^2) is a quadratic in it and the central difference is exact up
    to rounding."""
    _, t = _pair("earth", DIFF)
    ts, tst, tc, tcam = t
    n = tc.n_rays
    images = ts.textures.images.clone().requires_grad_()
    scene = ts._replace(textures=ts.textures._replace(images=images))
    rad = fused_diff.render_fused_diff(scene, tst, tc, tcam, 0, n, tc.seed)
    (grad,) = torch.autograd.grad((rad * rad).sum(), images)
    flat = int(grad.abs().argmax())
    eps = 1e-2

    def loss_at(v):
        img = ts.textures.images.clone()
        img.view(-1)[flat] = v
        sc = ts._replace(textures=ts.textures._replace(images=img))
        r, _ = mk.render_fused(sc, tc, tcam, 0, n, tc.seed, static=tst)
        return float((r.double() ** 2).sum())

    x = float(ts.textures.images.view(-1)[flat])
    fd = (loss_at(x + eps) - loss_at(x - eps)) / (2 * eps)
    assert abs(fd) > 0
    assert abs(fd - float(grad.view(-1)[flat])) <= 1e-3 * abs(fd)
