"""The port's differentiable planar render and inverse rendering against the JAX package.

`torch.autograd` through `fused_diff.render_fused_diff` (on the CPU: the
plain forward with winner codes, then the plain replay backward) against
`jax.grad` through JAX `render_fused_diff(interpret=True)`, leaf by leaf, a
finite-difference anchor, and `train.InverseRenderer` against the JAX one.
Scenes and sizes are those of tests/test_torch_planar.py.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from test_torch_planar import SEED, _scenes

from raytracer_weekend_tpu.fused_diff import render_fused_diff as jax_render_fused_diff
from raytracer_weekend_tpu.ops.pallas.megakernel import render_fused as jax_render_fused
from raytracer_weekend_tpu.train import InverseRenderer as JInverseRenderer
from raytracer_weekend_tpu_torch import fused_diff
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch import train
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as RB
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene.data import SceneData


def _agreeing_lanes(j, t):
    """1 where both packages' forwards trace the same path (the same codes,
    and radiance within 1e-4), else 0: such a lane's gradient belongs to
    another path (tests/test_torch_fused_diff.py)."""
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = tc.n_rays
    jrad, _, jcodes = jax_render_fused(js, jc, jcam, 0, n, jnp.uint32(SEED),
                                       interpret=True, static=jst,
                                       emit_paths=True)
    rad, _, codes = mk.render_fused(ts, tc, tcam, 0, n, SEED, static=tst,
                                    emit_paths=True)
    same = (np.asarray(jcodes).astype(np.int32) == codes.numpy()).all(axis=1)
    same &= np.isclose(rad.numpy(), np.asarray(jrad), rtol=1e-4,
                       atol=1e-4).all(axis=1)
    return same.astype(np.float32)


def _port_grads(t, w):
    ts, tst, tc, tcam = t
    leaves = [le.detach().clone() for le in ts.leaves()]
    cam = Camera(*(c.detach().clone().requires_grad_() for c in tcam))
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    rad = fused_diff.render_fused_diff(SceneData.from_leaves(leaves), tst, tc,
                                       cam, 0, tc.n_rays, SEED)
    loss = (torch.from_numpy(w)[:, None] * rad * rad).sum()
    grads = torch.autograd.grad(loss, floats + list(cam))
    got, _ = convert.grads_from_numpy(
        ts, [g.numpy() for g in grads[:len(floats)]])
    return got, Camera(*grads[len(floats):])


def _jax_grads(j, t, w):
    js, jst, jc, jcam = j
    n = jc.n_rays

    def loss(sc, cam):
        rad = jax_render_fused_diff(sc, jst, jc, cam, 0, n, jnp.uint32(SEED),
                                    interpret=True)
        return jnp.sum(jnp.asarray(w)[:, None] * rad * rad)

    gs, gc = jax.grad(loss, argnums=(0, 1), allow_int=True)(js, jcam)
    floats = [np.asarray(le) for le in jtu.tree_leaves(gs)
              if le.dtype != jax.dtypes.float0]
    return convert.grads_from_numpy(t[0], floats,
                                    jtu.tree_map(np.asarray, gc))


@pytest.mark.parametrize("name", ["cornell_box", "uv_shards"])
def test_fused_diff_grads_match_jax(name):
    """Every float leaf of scene and camera, GRADPARITY's metrics
    (tests/test_torch_fused_diff.py): norm_rel <= 5e-3, cos >= 0.999,
    max-abs <= 5e-3 of the leaf's scale, structurally zero leaves <= 1e-5.

    cornell_box runs K3-emit's and K4's plain versions. Its solid textures
    make the radiance piecewise constant in the geometry (winners fixed,
    attenuations the texture colors), so on both sides its geometry
    gradients are exactly zero and its colors and light carry the signal.
    uv_shards' uv-debug textures read the hit's (u, v), so its rect k,
    triangle vertices and (through the bounce directions) vertex normals
    get gradients; it takes the replay-autograd backward on both sides.
    """
    j, t = _scenes(name)
    w = _agreeing_lanes(j, t)
    assert w.sum() >= len(w) - max(4, len(w) // 100)
    got_s, got_c = _port_grads(t, w)
    want_s, want_c = _jax_grads(j, t, w)
    pairs = [(f, g, r) for f, g, r in zip(
        range(len(got_s.leaves())), got_s.leaves(), want_s.leaves())
        if r is not None] + [(None, g, r) for g, r in zip(got_c, want_c)]
    gscale = max(float(r.abs().max()) for _, _, r in pairs if r.numel())
    for _, g, r in pairs:
        g, r = g.detach().numpy(), r.numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        if not r.size:
            continue
        scale = float(np.abs(r).max())
        if scale <= gscale * 1e-7:
            assert np.abs(g).max() <= max(gscale, 1.0) * 1e-5
            continue
        na = np.linalg.norm(r)
        assert np.linalg.norm(g - r) / na <= 5e-3
        assert float((g * r).sum()) / (na * np.linalg.norm(g)) >= 0.999
        assert np.abs(g - r).max() / scale < 5e-3
    geo = {"rects.k": got_s.rects.k, "triangles.v0": got_s.triangles.v0,
           "triangles.n0": got_s.triangles.n0}
    for key, g in geo.items():
        assert bool(torch.isfinite(g).all()), key
        if name == "uv_shards":
            assert float(g.abs().max()) > 0, key
        else:
            assert not g.any(), key
    assert float(got_s.textures.color1.abs().max()) > 0


def test_triangle_vertex_grad_matches_finite_difference():
    """A finite-difference anchor on simple_triangle's uv-debug triangle:
    d loss / d v1.y through render_fused_diff against the central
    difference of the plain forward render. Lanes whose codes change under
    the +-eps moves (a triangle edge crossing them) weigh 0 in both.
    Measured: relative difference 1.8e-4 at eps 1e-2 (8.9e-5 at 3e-3: the
    central difference's own error, plus the forward's staged scalar-triple
    (u, v) against the replay's affine one); budget 2e-3."""
    _, t = _scenes("simple_triangle")
    ts, tst, tc, tcam = t
    n, eps, coord = tc.n_rays, 1e-2, (0, 1)

    def forward(delta):
        v1 = ts.triangles.v1.clone()
        v1[coord] += delta
        sc = ts._replace(triangles=ts.triangles._replace(v1=v1))
        rad, _, codes = mk.render_fused(sc, tc, tcam, 0, n, SEED, static=tst,
                                        emit_paths=True)
        return rad.double(), codes

    (r_p, c_p), (r_m, c_m), (_, c_0) = forward(eps), forward(-eps), forward(0)
    w = ((c_p == c_0).all(1) & (c_m == c_0).all(1)).double()
    assert w.sum() >= n - n // 50
    fd = float((w[:, None] * (r_p ** 2 - r_m ** 2)).sum()) / (2 * eps)

    v1 = ts.triangles.v1.detach().clone().requires_grad_()
    sc = ts._replace(triangles=ts.triangles._replace(v1=v1))
    rad = fused_diff.render_fused_diff(sc, tst, tc, tcam, 0, n, SEED)
    (grad,) = torch.autograd.grad((w.float()[:, None] * rad * rad).sum(), v1)
    assert abs(fd) > 1e-2
    assert abs(fd - float(grad[coord])) <= 2e-3 * abs(fd)


def test_fused_diff_on_the_cow_matches_staged_autograd():
    """render_fused_diff on the cow (1 sphere, 1 rect, 5,804 triangles:
    every family and the unified planar index in one launch) against torch
    autograd of the staged render, every float leaf. The radiance is the
    same plain forward, so bitwise equal; gradients to 1e-5 of each leaf's
    scale (the replay re-derives each hit in the affine planar form, the
    staged path in its own). Geometry gradients are 0 on both sides (solid
    textures; see test_fused_diff_grads_match_jax). The cow is built
    without its tree, so that the staged path is the brute force the fused
    path's plain version is (a tree's walk would round and break ties its
    own way: tests/test_torch_bvh.py)."""
    cfg = TConfig(width=12, height=8, samples_per_pixel=2, max_depth=4,
                  seed=SEED)
    objs, cams, bg = TS.wavefront_cow_obj(cfg.aspect_ratio)
    ts, tst = TB.build_scene(objs, background=bg, bvh=False)
    cam, n = cams[0], cfg.n_rays

    def grads(render):
        leaves = [le.detach().clone() for le in ts.leaves()]
        floats = [le.requires_grad_() for le in leaves
                  if le.is_floating_point()]
        rad = render(SceneData.from_leaves(leaves))
        return rad.detach(), torch.autograd.grad(
            (rad * rad).sum(), floats, allow_unused=True)

    rad, got = grads(lambda sc: fused_diff.render_fused_diff(
        sc, tst, cfg, cam, 0, n, SEED))
    ref_rad, want = grads(lambda sc: TI.render_chunk(
        sc, tst, cfg, cam, torch.arange(n), SEED))
    assert torch.equal(rad, ref_rad) and float(rad.abs().max()) > 0
    for g, w in zip(got, want):
        w = torch.zeros_like(g) if w is None else w
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * max(float(w.abs().max()), 1.0))
    got_s, _ = convert.grads_from_numpy(ts, [g.numpy() for g in got])
    assert float(got_s.textures.color1.abs().max()) > 0
    assert not got_s.triangles.v0.any() and not got_s.rects.k.any()


# ---- inverse rendering --------------------------------------------------

def test_inverse_renderer_lowers_loss_on_cornell():
    """InverseRenderer.fit on a small cornell_box (12x12, 2 spp, depth 4),
    three Adam steps from color1 + 0.2, against the JAX InverseRenderer
    (loss histories to rtol 1e-3, as tests/test_torch_train.py)."""
    size = dict(width=12, height=12, samples_per_pixel=2, max_depth=4)
    (js, jst, jc, jcam), (ts, tst, tc, tcam) = _scenes("cornell_box", **size)
    target = TI.render_image(ts, tst, tc, tcam) / tc.samples_per_pixel
    tstart = ts._replace(textures=ts.textures._replace(
        color1=ts.textures.color1 + 0.2))
    jstart = js._replace(textures=js.textures._replace(
        color1=js.textures.color1 + 0.2))
    launches = mk.PLANAR_LAUNCHES, RB.PLANAR_LAUNCHES
    fit, hist = train.InverseRenderer(tst, tc, tcam, target,
                                      learning_rate=0.05).fit(tstart, steps=3)
    assert (mk.PLANAR_LAUNCHES, RB.PLANAR_LAUNCHES) == launches
    assert hist[-1] < hist[0]
    assert all(bool(torch.isfinite(le).all()) for le in fit.leaves()
               if le.is_floating_point())
    _, jhist = JInverseRenderer(jst, jc, jcam, jnp.asarray(target.numpy()),
                                learning_rate=0.05).fit(jstart, steps=3)
    np.testing.assert_allclose(hist, jhist, rtol=1e-3)
