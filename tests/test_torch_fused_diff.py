"""The port's differentiable fused render against the JAX package's, leaf by leaf.

`torch.autograd` through `fused_diff.render_fused_diff` (on the CPU: the plain
forward with winner codes, then the plain replay backward) against
`jax.grad` through JAX `render_fused_diff(interpret=True)`, for every float
leaf of the scene and the camera. Sizes as tests/test_torch_render.py.

Each package runs its own forward, so on jumpy_balls the two trace
different paths on the few lanes where a near-tangent hit flips (19 of 2304
lanes record other winners at this size, tests/test_torch_diff.py, and a
few more land in another checker cell of the same sphere). Such a lane's
gradient belongs to another path, so the loss weighs it 0 on both sides:
only lanes whose paths agree enter the comparison. The metrics are GRADPARITY's
(tools/gradparity_r5.py): per leaf norm_rel and cos, a max-abs bound as in
tests/test_fused_diff.py:53-78, and a zero rule for structurally zero leaves.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from test_torch_render import _scenes

from raytracer_weekend_tpu.fused_diff import render_fused_diff as jax_render_fused_diff
from raytracer_weekend_tpu.ops.pallas.megakernel import render_fused as jax_render_fused
from raytracer_weekend_tpu_torch import fused_diff
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as RB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene.data import SceneData

NORM_REL, COS, MAX_REL = 5e-3, 0.999, 5e-3
ZERO_ATOL = 1e-5   # GRADPARITY: |got| / max(largest gradient, 1), zero leaves


def _agreeing_lanes(j, t):
    """Weights (n,) f32: 1 where both packages' forwards trace the same path
    (the same winner codes, and radiance within 1e-4, which also rules out a
    checker cell flipped on the same sphere), else 0."""
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = tc.n_rays
    jrad, _, jcodes = jax_render_fused(js, jc, jcam, 0, n, jnp.uint32(3),
                                       interpret=True, static=jst,
                                       emit_paths=True)
    rad, _, codes = mk.render_fused(ts, tc, tcam, 0, n, 3, static=tst,
                                    emit_paths=True)
    same = (np.asarray(jcodes).astype(np.int32) == codes.numpy()).all(axis=1)
    same &= np.isclose(rad.numpy(), np.asarray(jrad), rtol=1e-4,
                       atol=1e-4).all(axis=1)
    return same.astype(np.float32)


def _port_grads(t, w):
    """d sum(w * rad^2) through the port -> (SceneData, Camera) of grads."""
    ts, tst, tc, tcam = t
    leaves = [le.detach().clone() for le in ts.leaves()]
    cam = Camera(*(c.detach().clone().requires_grad_() for c in tcam))
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    scene = SceneData.from_leaves(leaves)
    launches = RB.LAUNCHES, mk.LAUNCHES, mk.EMIT_LAUNCHES
    rad = fused_diff.render_fused_diff(scene, tst, tc, cam, 0, tc.n_rays, 3)
    loss = (torch.from_numpy(w)[:, None] * rad * rad).sum()
    grads = torch.autograd.grad(loss, floats + list(cam))
    # The CPU runs the plain versions: no kernel launches.
    assert (RB.LAUNCHES, mk.LAUNCHES, mk.EMIT_LAUNCHES) == launches
    got, _ = convert.grads_from_numpy(
        ts, [g.numpy() for g in grads[:len(floats)]])
    return got, Camera(*grads[len(floats):])


def _jax_grads(j, t, w):
    js, jst, jc, jcam = j
    n = jc.n_rays

    def loss(sc, cam):
        rad = jax_render_fused_diff(sc, jst, jc, cam, 0, n, jnp.uint32(3),
                                    interpret=True)
        return jnp.sum(jnp.asarray(w)[:, None] * rad * rad)

    gs, gc = jax.grad(loss, argnums=(0, 1), allow_int=True)(js, jcam)
    floats = [np.asarray(le) for le in jtu.tree_leaves(gs)
              if le.dtype != jax.dtypes.float0]
    return convert.grads_from_numpy(t[0], floats,
                                    jtu.tree_map(np.asarray, gc))


@pytest.mark.parametrize("name", ["two_spheres", "jumpy_balls"])
def test_fused_diff_grads_match_jax(name):
    """(d) Every float leaf of scene and camera. Measured: largest norm_rel
    2.2e-6 (two_spheres, no lane weighed out) and 1.9e-6 (jumpy_balls, 25
    lanes weighed out); cos 1.0 on every live leaf. Without the weights,
    jumpy_balls' color1 gradient measured norm_rel 8.7e-3 and max-abs
    7.4e-3 of its scale, all of it from the other paths of flipped lanes."""
    j, t = _scenes(name)
    w = _agreeing_lanes(j, t)
    if name == "two_spheres":
        assert w.all()
    assert w.sum() >= len(w) - max(4, len(w) // 64)
    got_s, got_c = _port_grads(t, w)
    want_s, want_c = _jax_grads(j, t, w)
    pairs = [(g, r) for g, r in zip(got_s.leaves(), want_s.leaves())
             if r is not None] + list(zip(got_c, want_c))
    gscale = max(float(r.abs().max()) for _, r in pairs if r.numel())
    live = 0
    for g, r in pairs:
        g, r = g.detach().numpy(), r.numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        if not r.size:
            continue
        scale = float(np.abs(r).max())
        if scale <= gscale * 1e-7:
            assert np.abs(g).max() <= max(gscale, 1.0) * ZERO_ATOL
            continue
        live += 1
        na = np.linalg.norm(r)
        assert np.linalg.norm(g - r) / na <= NORM_REL
        assert float((g * r).sum()) / (na * np.linalg.norm(g)) >= COS
        assert np.abs(g - r).max() / scale < MAX_REL
    assert live >= 3   # color1, color2, background


def test_background_grad_matches_finite_difference():
    """A finite-difference anchor: the radiance is affine in the background
    once the paths are fixed (no discrete choice depends on it), so sum(rad^2)
    is a quadratic in each channel and its central difference is exact up
    to rounding."""
    _, t = _scenes("two_spheres")
    ts, tst, tc, tcam = t
    n = tc.n_rays
    bg = ts.background.detach().clone().requires_grad_()
    rad = fused_diff.render_fused_diff(ts._replace(background=bg), tst, tc,
                                       tcam, 0, n, 3)
    (grad,) = torch.autograd.grad((rad * rad).sum(), bg)
    c = int(grad.abs().argmax())
    eps = 1e-2

    def loss_at(v):
        bgv = ts.background.clone()
        bgv[c] = v
        r, _ = mk.render_fused(ts._replace(background=bgv), tc, tcam, 0, n, 3,
                               static=tst)
        return float((r.double() ** 2).sum())

    b = float(ts.background[c])
    fd = (loss_at(b + eps) - loss_at(b - eps)) / (2 * eps)
    assert abs(fd - float(grad[c])) <= 1e-3 * abs(fd)


@pytest.mark.parametrize("field", ["n_volumes", "has_noise", "has_image"])
def test_fused_diff_rejects_unsupported_scenes(field):
    """Media, noise and image textures are supported: a scene flagged with
    media takes the medium route (the forward with the volume family, the
    backward torch autograd of the replay), one flagged with noise or image
    textures the deferred-texture forward and backward; with no such thing
    in the scene (the volume table's one row is invalid) both give the
    radiance and the gradients of the unflagged scene."""
    _, t = _scenes("two_spheres")
    ts, tst, tc, tcam = t
    static = type(tst)(**{**tst.__dict__, field: 1})
    out = []
    for st in (tst, static):
        bg = ts.background.clone().requires_grad_()
        c1 = ts.textures.color1.clone().requires_grad_()
        sc = ts._replace(background=bg,
                         textures=ts.textures._replace(color1=c1))
        rad = fused_diff.render_fused_diff(sc, st, tc, tcam, 0, 64, 3)
        out.append((rad, *torch.autograd.grad((rad * rad).sum(), (bg, c1))))
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert float(out[1][1].abs().max()) > 0
