"""The depth-phased render (`render_fused_deep`) and the chained combine.

The plain version of the phased render (each phase `phase_reference`:
`integrator.trace_lanes` with a carry and d0, the live lanes gathered
between phases) must give the plain single pass's lanes bit for bit, on
book2 (media, noise and image texels chained across phases) at 10x6, 1
spp, depth 20 and jumpy_balls at 20x12, 1 spp, depth 12, with phases of 4
bounces: JAX's cases at tests/test_megakernel.py:396-418. The combine's
`return_factors` is held against JAX `_combine_deferred(return_factors=
True)` on the same records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops.pallas.megakernel import _combine_deferred
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models.scenes import generate_scene
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk


@pytest.mark.parametrize("name, w, h, depth", [
    ("book2_final_scene", 10, 6, 20), ("jumpy_balls", 20, 12, 12)])
def test_deep_plain_matches_single_pass(name, w, h, depth):
    data, static, cams = generate_scene(name, 16 / 9, device="cpu")
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=1,
                       max_depth=depth)
    live = []
    rad_d, seg_d = mk.render_fused_deep(data, cfg, cams[0], 0, cfg.n_rays, 7,
                                        static=static, phase_len=4,
                                        live_counts=live)
    rad_s, seg_s = mk.render_fused(data, cfg, cams[0], 0, cfg.n_rays, 7,
                                   static=static, deep=False)
    assert torch.equal(rad_d, rad_s) and torch.equal(seg_d, seg_s)
    # The lanes were compacted, and some lived past the first phase.
    assert len(live) >= 2 and 0 < live[-1] < live[0] < cfg.n_rays
    # render_fused chooses the phased render for a whole frame at depth 16+.
    if depth >= mk.DEEP_MIN_DEPTH:
        before = len(live)
        auto = mk.render_fused(data, cfg, cams[0], 0, cfg.n_rays, 7,
                               static=static)
        assert torch.equal(auto[0], rad_s) and torch.equal(auto[1], seg_s)
        assert before == len(live)


def test_phase_reference_resumes():
    """Two phases of the plain phased launch equal one of both lengths: the
    state (o, d, throughput, radiance, time, alive, segments) carries the
    lane, and the random numbers key on the absolute depth."""
    data, static, cams = generate_scene("two_spheres", 16 / 9, device="cpu")
    cfg = RenderConfig(width=16, height=9, samples_per_pixel=2, max_depth=6)
    lanes = torch.arange(cfg.n_rays, dtype=torch.int32)
    cfg3 = RenderConfig(width=16, height=9, samples_per_pixel=2, max_depth=3)
    *_, st1 = mk.phase_reference(data, cfg3, cams[0], lanes, None, 0, 5,
                                 static=static)
    rad2, seg2, st2 = mk.phase_reference(data, cfg3, cams[0], lanes, st1, 3,
                                         5, static=static)
    rad, seg, st = mk.phase_reference(data, cfg, cams[0], lanes, None, 0, 5,
                                      static=static)
    assert st.shape == (cfg.n_rays, mk.STATE_SIZE)
    assert torch.equal(rad2, rad) and torch.equal(seg2, seg)
    assert torch.equal(st2, st)


@pytest.fixture(scope="module")
def records():
    """book2's plain records at 32x18, 4 spp, depth 6 and its JAX scene."""
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6)
    data, static, cams = generate_scene("book2_final_scene", 16 / 9,
                                        device="cpu")
    _, _, ctb, abc, dcode = mk.records_reference(
        data, cfg, cams[0], 0, cfg.n_rays, 3, static=static)
    objs, _, bg = JS.book2_final_scene(16 / 9, seed=0)
    js, _ = JB.build_scene(objs, background=bg, seed=0, bvh=False)
    return data, static, js, ctb, abc, dcode


def test_combine_return_factors_matches_jax(records):
    data, static, js, ctb, abc, dcode = records
    assert int((dcode != 0).sum()) > 20
    rad, fac = mk.combine_deferred(data.textures, ctb, abc, dcode,
                                   has_noise=True, has_image=True,
                                   return_factors=True)
    dfr = np.concatenate([abc.numpy(), dcode.numpy()[..., None].astype(
        np.float32)], axis=-1)
    jrad, jfac = _combine_deferred(js, jnp.asarray(ctb.numpy()),
                                   jnp.asarray(dfr), has_noise=True,
                                   has_image=True, return_factors=True)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(fac.numpy(), np.asarray(jfac), rtol=1e-5,
                               atol=1e-6)
    assert float((fac - 1.0).abs().max()) > 0.01


def test_combine_chains_bitwise(records):
    """The combine of the first k records continued (init) over the rest is
    the combine of all of them, bit for bit: how the phases chain."""
    data, static, _, ctb, abc, dcode = records
    kw = dict(has_noise=True, has_image=True)
    whole, fac = mk.combine_deferred(data.textures, ctb, abc, dcode, **kw,
                                     return_factors=True)
    acc = mk.combine_deferred(data.textures, ctb[:, :2], abc[:, :2],
                              dcode[:, :2], **kw, return_factors=True)
    rad, f = mk.combine_deferred(data.textures, ctb[:, 2:], abc[:, 2:],
                                 dcode[:, 2:], **kw, init=acc,
                                 return_factors=True)
    assert torch.equal(rad, whole) and torch.equal(f, fac)
    assert torch.equal(whole, mk.combine_deferred(data.textures, ctb, abc,
                                                  dcode, **kw))
