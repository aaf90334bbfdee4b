"""The port's winner codes, path replay and replay backward against the JAX package.

Sizes as tests/test_torch_render.py: 32x18, 4 spp, depth 6, seed 3. The JAX
side runs as its own tests run it: `render_fused(interpret=True,
emit_paths=True)`, `replay_bwd_fused(interpret=True)`. Both packages replay
the SAME winner codes (JAX's, converted from its f32 form to int32 here, at
the comparison boundary), so no near-tangent winner flip enters the
backward comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import _scenes

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu.ops.pallas import replay_bwd as JRB
from raytracer_weekend_tpu.ops.pallas.megakernel import render_fused as jax_render_fused
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch import replay
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as RB
from raytracer_weekend_tpu_torch.scene import convert
from raytracer_weekend_tpu_torch.scene.data import SceneData

SCENES = ["two_spheres", "jumpy_balls"]


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    """(jax side, port side, JAX fused forward with codes) for one scene."""
    j, t = _scenes(request.param)
    js, jst, jc, jcam = j
    n = jc.n_rays
    rad, seg, codes = jax_render_fused(js, jc, jcam, 0, n, jnp.uint32(3),
                                       interpret=True, static=jst,
                                       emit_paths=True)
    codes = np.asarray(codes)
    codes_i = codes.astype(np.int32)
    # The f32 codes are exact integers: the int32 form carries them whole.
    np.testing.assert_array_equal(codes_i.astype(np.float32), codes)
    return request.param, j, t, (np.asarray(rad), np.asarray(seg), codes_i)


def _nonzero_vs_seg(codes, seg):
    """Lanes alive at a bounce's start either hit (code > 0) or missed last."""
    nz = (codes > 0).sum(axis=1)
    return bool(((nz == seg) | (nz == seg - 1)).all())


def test_codes_match_jax(pair):
    """(a) The plain version's codes against JAX K1 with emit_paths."""
    name, j, t, (jrad, jseg, jcodes) = pair
    ts, tst, tc, tcam = t
    n = tc.n_rays
    rad, seg, codes = mk.render_fused(ts, tc, tcam, 0, n, 3, static=tst,
                                      emit_paths=True)
    assert codes.shape == (n, tc.max_depth) and codes.dtype == torch.int32
    # The codes ride along: radiance and segments are those of the launch
    # without them.
    rad0, seg0 = mk.render_fused(ts, tc, tcam, 0, n, 3, static=tst)
    assert torch.equal(rad, rad0) and torch.equal(seg, seg0)
    codes = codes.numpy()
    assert _nonzero_vs_seg(codes, seg.numpy())
    assert _nonzero_vs_seg(jcodes, jseg.astype(np.int64))
    assert (codes > 0).any() and ((codes[codes > 0] & 3) == 1).all()
    differ = int((codes != jcodes).any(axis=1).sum())
    # Measured: two_spheres 0 lanes, jumpy_balls 19 (the near-tangent flips
    # of tests/test_torch_render.py); budget of tests/test_megakernel.py:66-70.
    assert differ <= max(4, n // 64)
    if name == "two_spheres":
        assert differ == 0


def test_replay_reproduces_forward(pair):
    """(b) replay_rays on JAX's codes: equal to JAX's own replay, and the
    port's forward radiance back (as tests/test_fused_diff.py:35-50).

    On jumpy_balls the replay recomputes t with the direct quadratic from
    the alpha/beta center where the forward used the staged one, so a few
    lanes re-shade differently; JAX's own replay differs from JAX's forward
    on 10 lanes at this size. Measured for the port: 0 lanes (two_spheres),
    20 lanes (jumpy_balls, including the 19 whose codes differ), inside the
    flip budget of tests/test_megakernel.py:66-70.
    """
    name, j, t, (jrad, jseg, jcodes) = pair
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = tc.n_rays
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), 3)
    got = TI.replay_rays(ts, tst, tc, o, d, tm, rid, 3,
                         torch.from_numpy(jcodes)).numpy()
    jo, jd, jt, jrid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                      jnp.uint32(3))
    want = np.asarray(JI.replay_rays(js, jst, jc, jo, jd, jt, jrid,
                                     jnp.uint32(3), jnp.asarray(jcodes)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fwd, _ = mk.render_fused(ts, tc, tcam, 0, n, 3, static=tst)
    fwd = fwd.numpy()
    bad = ~np.isclose(got, fwd, rtol=1e-4, atol=1e-4)
    n_bad = int(bad.any(axis=1).sum())
    if name == "two_spheres":
        np.testing.assert_allclose(got, fwd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, jrad, rtol=1e-4, atol=1e-4)
    assert n_bad <= max(4, n // 64)


def test_replay_bwd_reference_matches_jax_kernel(pair):
    """(c) The backward alone: replay_bwd_reference against JAX
    replay_bwd_fused(interpret=True), both on JAX's codes, g = 2 rad, as
    tests/test_fused_diff.py:152-209. Every output, the table cotangent
    mapped to the scene leaves by each package's own pack_ktab."""
    name, j, t, (jrad, jseg, jcodes) = pair
    js, jst, jc, jcam = j
    ts, tst, tc, tcam = t
    n = tc.n_rays
    seed = jnp.uint32(3)
    jo, jd, jt, jrid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                      seed)
    g = 2.0 * jrad
    jk = JRB.pack_ktab(js)
    jdk, _, jdo, jdd, jdt, jdbg = JRB.replay_bwd_fused(
        jk, None, js.background, jc, jo, jd, jt, jrid, seed,
        jnp.asarray(jcodes, jnp.float32), jnp.asarray(g), n, interpret=True)

    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), 3)
    leaves = [le.detach().clone() for le in ts.leaves()]
    floats = [le.requires_grad_() for le in leaves if le.is_floating_point()]
    ktab = RB.pack_ktab(SceneData.from_leaves(leaves))
    np.testing.assert_array_equal(ktab.detach().numpy(),
                                  np.asarray(jk)[:RB.KT])
    dk, dp, do, dd, dt, dbg = RB.replay_bwd_fused(
        ktab, None, ts.background, tc, o, d, tm, rid, 3,
        torch.from_numpy(jcodes), torch.from_numpy(g), n)
    assert dk.shape == (RB.KT, ts.spheres.c0.shape[0]) and dp is None

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max() if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=max(scale, 1.0) * 2e-5)

    close(dk.numpy(), np.asarray(jdk)[:RB.KT])
    close(do.numpy(), jdo)
    close(dd.numpy(), jdd)
    close(dt.numpy(), jdt)
    close(dbg.numpy(), jdbg)
    # Geometry, camera and time cotangents are structurally zero for solid
    # and checker textures; only colors and the background carry signal.
    assert not do.any() and not dd.any() and not dt.any()
    assert dbg.abs().max() > 0 and dk.abs().max() > 0

    # d(ktab) mapped to the scene leaves, each package through its own
    # pack_ktab.
    got = torch.autograd.grad(ktab, floats, grad_outputs=dk,
                              allow_unused=True)
    got = [torch.zeros_like(le) if gr is None else gr
           for gr, le in zip(got, floats)]
    _, vjp = jax.vjp(JRB.pack_ktab, js)
    want_tree = vjp(jdk)[0]
    want = [np.asarray(le) for le in jax.tree_util.tree_leaves(want_tree)
            if le.dtype != jax.dtypes.float0]
    want_scene, _ = convert.grads_from_numpy(ts, want)
    got_scene, _ = convert.grads_from_numpy(ts, [gr.numpy() for gr in got])
    live = 0
    for w, gr in zip(want_scene.leaves(), got_scene.leaves()):
        if w is None:
            continue
        close(gr.numpy(), w.numpy())
        live += bool(w.abs().max() > 0)
    assert live >= 2   # color1 and color2 (two_spheres: both checker)


@pytest.mark.parametrize("field", ["n_volumes", "has_noise", "has_image"])
def test_replay_rejects_unported_families(field):
    """Every family is ported now: a scene flagged with media, noise or
    image textures (with no such thing in it: the volume table's one row is
    invalid) replays to the radiance of the unflagged scene."""
    _, t = _scenes("two_spheres")
    ts, tst, tc, tcam = t
    n = 256
    o, d, tm, rid = TI._pixel_rays(tcam, tc, torch.arange(n), 3)
    _, _, codes = mk.render_fused(ts, tc, tcam, 0, n, 3, static=tst,
                                  emit_paths=True)
    static = type(tst)(**{**tst.__dict__, field: 1})
    want = replay.replay_rays(ts, tst, tc, o, d, tm, rid, 3, codes)
    got = replay.replay_rays(ts, static, tc, o, d, tm, rid, 3, codes)
    assert torch.equal(got, want) and float(want.max()) > 0
