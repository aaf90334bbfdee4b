"""The port's Perlin noise, textures, textured scenes and staged render against the JAX package.

Inputs are made from a seed with numpy and handed to both packages. The JAX
side runs as its own tests run it: jnp (`perlin`, `textures`, the staged
`render_chunk`) and the Pallas turbulence VJP in interpret mode. Scenes:
earth (an image-textured sphere), two_perlin_spheres (noise) and
simple_light (noise ground and sphere, an image-textured rect and sphere
light, black background).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu import perlin as jperlin
from raytracer_weekend_tpu import textures as jtex
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops.pallas.perlin_turb import turbulence_vjp_pallas
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch import perlin as tperlin
from raytracer_weekend_tpu_torch import textures as ttex
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb
from raytracer_weekend_tpu_torch.scene import builder as TB

SCENES = ["earth", "two_perlin_spheres", "simple_light"]


def _tables(seed=3):
    g, pm = tperlin.make_perlin_tables(seed)
    return g, pm, torch.from_numpy(g), torch.from_numpy(pm)


def _points(n, seed=1, scale=7.0):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    p[:4] = [[0, 0, 0], [-0.5, 1e-7, 255.5], [1000.25, -3.75, 64.0],
             [-1e3, 2e3, -0.999]]
    return p


def test_perlin_tables_match():
    for seed in (0, 3):
        jg, jp = jperlin.make_perlin_tables(seed)
        tg, tp = tperlin.make_perlin_tables(seed)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("depth", [1, 7])
def test_noise_and_turbulence_match_jax(depth):
    g, pm, tg, tpm = _tables()
    p = _points(4096)
    want_n = np.asarray(jperlin.noise(jnp.asarray(g), jnp.asarray(pm),
                                      jnp.asarray(p)))
    got_n = tperlin.noise(tg, tpm, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got_n, want_n, atol=1e-5, rtol=0)
    want = np.asarray(jperlin.turbulence(jnp.asarray(g), jnp.asarray(pm),
                                         jnp.asarray(p), depth))
    got = tperlin.turbulence(tg, tpm, torch.from_numpy(p), depth).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.std() > 0.05       # the noise is not flat


def test_turbulence_wrapper_live_mask():
    """K8's plain version: dead points are 0, live points the turbulence."""
    _, _, tg, tpm = _tables()
    p = torch.from_numpy(_points(3000))
    live = torch.from_numpy(np.random.default_rng(2).random(3000) < 0.3)
    got = perlin_turb.turbulence(tg, tpm, p, 7, live)
    want = tperlin.turbulence(tg, tpm, p, 7)
    assert perlin_turb.TURB_LAUNCHES == 0   # the CPU runs the plain version
    assert torch.equal(got[~live], torch.zeros(int((~live).sum())))
    assert torch.equal(got[live], want[live])


def test_turbulence_vjp_matches_jax():
    """K9's plain version against jax.vjp of the jnp turbulence (all live)
    and against the Pallas VJP kernel in interpret mode with a real live
    mask over 12 of its 1024-point tiles (tests/test_pallas_kernels.py:
    169). The Pallas kernel needs dead cotangents zeroed by its caller and
    leaves d_p of dead points in live tiles unmasked; the port masks dead
    points itself: their d_p is exactly 0."""
    g, pm, tg, tpm = _tables()
    rng = np.random.default_rng(1)
    n = 12000
    p = (rng.normal(size=(n, 3)) * 7).astype(np.float32)
    ct = rng.normal(size=(n,)).astype(np.float32)
    live = rng.random(n) < 0.3

    _, vjp = jax.vjp(lambda g_, p_: jperlin.turbulence(g_, jnp.asarray(pm),
                                                       p_, 7),
                     jnp.asarray(g), jnp.asarray(p))
    dg_all, dp_all = map(np.asarray, vjp(jnp.asarray(ct)))
    tdg, tdp = perlin_turb.turbulence_vjp(tg, tpm, torch.from_numpy(p),
                                          torch.from_numpy(ct), 7)
    np.testing.assert_allclose(tdp.numpy(), dp_all, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tdg.numpy(), dg_all, atol=1e-5, rtol=0)

    ct_live = ct * live
    jdg, jdp = turbulence_vjp_pallas(jnp.asarray(g), jnp.asarray(pm),
                                     jnp.asarray(p), jnp.asarray(ct_live), 7,
                                     interpret=True, live=jnp.asarray(live))
    # Unzeroed cotangents: the mask alone must drop the dead points.
    tdg, tdp = perlin_turb.turbulence_vjp(tg, tpm, torch.from_numpy(p),
                                          torch.from_numpy(ct), 7,
                                          torch.from_numpy(live))
    tdp = tdp.numpy()
    assert (tdp[~live] == 0.0).all()
    np.testing.assert_allclose(tdp[live], np.asarray(jdp)[live], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), atol=1e-5,
                               rtol=0)
    assert np.abs(tdg.numpy()).max() > 1.0


def test_turbulence_diff_autograd():
    """turbulence_diff's backward is turbulence_vjp (the plain one here)."""
    _, _, tg, tpm = _tables()
    p = torch.from_numpy(_points(500)).requires_grad_()
    g = tg.clone().requires_grad_()
    live = torch.arange(500) % 3 != 0
    out = perlin_turb.turbulence_diff(g, tpm, p, 7, live)
    ct = torch.linspace(-1, 1, 500)
    dg, dp = torch.autograd.grad(out, (g, p), ct)
    wg, wp = perlin_turb.turbulence_vjp_reference(tg, tpm, p.detach(), ct, 7,
                                                  live)
    assert torch.equal(dg, wg) and torch.equal(dp, wp)


def _textured_table():
    """simple_light's texture table (noise, image and solid rows) from both
    builders."""
    objs, _, bg = JS.simple_light(1.5)
    from raytracer_weekend_tpu.scene import builder as JB

    jdata, _ = JB.build_scene(objs, background=bg, seed=0)
    tdata, _, _ = TS.generate_scene("simple_light", 1.5, device="cpu")
    return jdata.textures, tdata.textures


@pytest.mark.parametrize("bilinear", [False, True])
def test_texture_value_matches_jax(bilinear):
    """The noise and image arms, nearest and bilinear, with every texture row
    of simple_light, at random (u, v) around [0, 1] and random points."""
    jt, tt = _textured_table()
    assert set(np.asarray(jt.ttype).tolist()) >= {ttex.NOISE, ttex.IMAGE}
    rng = np.random.default_rng(5)
    n = 5000
    tex_id = rng.integers(0, len(jt.ttype), n).astype(np.int32)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    p = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    want = np.asarray(jtex.texture_value(
        jt, jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(p), has_noise=True, has_image=True, bilinear=bilinear))
    got = ttex.texture_value(tt, torch.from_numpy(tex_id), torch.from_numpy(u),
                             torch.from_numpy(v), torch.from_numpy(p),
                             has_noise=True, has_image=True,
                             bilinear=bilinear).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_earthmap_asset_is_pil_decode():
    """The package's decoded earthmap equals Pillow's decode of the JPEG in
    models/, byte for byte, and the catalog texels are that / 255."""
    with Image.open(TS.model_path("earthmap.jpg")) as im:
        want = np.asarray(im.convert("RGB"))
    with np.load(TS._EARTHMAP) as z:
        got = z["earthmap"]
    assert got.dtype == np.uint8 and got.shape == (512, 1024, 3)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        TS.earthmap(), np.asarray(want, dtype=np.float32) / 255.0)
    tex = TB.ImageTexture(TS.model_path("earthmap.jpg"))   # Pillow decode
    np.testing.assert_array_equal(tex.data, TS.earthmap())


@pytest.mark.parametrize("name", SCENES)
def test_builder_tables_bit_equal(name):
    jdata, jstatic, jcams = JS.generate_scene(name, 16 / 9)
    tdata, tstatic, tcams = TS.generate_scene(name, 16 / 9, device="cpu")
    assert dataclasses.asdict(tstatic) == dataclasses.asdict(jstatic)
    for fam in ("spheres", "rects", "triangles", "volumes", "materials",
                "textures"):
        jt, tt = getattr(jdata, fam), getattr(tdata, fam)
        for f in jt._fields:
            want = np.asarray(getattr(jt, f))
            got = getattr(tt, f).numpy()
            assert got.dtype == want.dtype, (fam, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{fam}.{f}")
    np.testing.assert_array_equal(tdata.background.numpy(),
                                  np.asarray(jdata.background))
    assert tstatic.fused_simple
    assert tstatic.defer_single_hit == (name == "earth")
    for a, b in zip(tcams[0], jcams[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_generate_scene_device():
    """The card by default: without one it raises and never builds on the
    CPU unless asked."""
    data, _, cams = TS.generate_scene("earth", 1.5, device="cpu")
    assert data.device.type == "cpu" and cams[0].origin.device.type == "cpu"
    if torch.cuda.is_available():
        data, _, cams = TS.generate_scene("earth", 1.5)
        assert data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.generate_scene("earth", 1.5)


def test_image_texture_needs_a_decoder_or_data():
    with pytest.raises(ValueError):
        TB.ImageTexture()
    with pytest.raises(ValueError):
        TB.ImageTexture(data=np.zeros((4, 4)))


def _flips(got, ref, got_seg, ref_seg):
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-3)
    bad = len(np.unique(np.argwhere(rel > 0.05)[:, 0]))
    return abs(int(got_seg) - int(ref_seg)), bad, float(np.abs(got - ref).mean())


@pytest.mark.parametrize("name", SCENES)
def test_staged_render_matches_jax(name):
    """The staged path with inline noise and image texels (the semantic
    reference of the deferred fused render) against JAX `trace_rays` at
    24x16, 4 spp, depth 6, with the budgets of tests/test_megakernel.py:
    322-328."""
    kw = dict(width=24, height=16, samples_per_pixel=4, max_depth=6, seed=3)
    jc, tc = JConfig(use_pallas=False, **kw), TConfig(**kw)
    js, jst, jcams = JS.generate_scene(name, jc.aspect_ratio)
    ts, tst, tcams = TS.generate_scene(name, tc.aspect_ratio, device="cpu")
    n = tc.n_rays
    o, d, t, rid = JI._pixel_rays(jcams[0], jc, jnp.arange(n, dtype=jnp.int32),
                                  jnp.uint32(3))
    with jax.disable_jit():
        ref, ref_seg = JI.trace_rays(js, jst, jc, o, d, t, rid, jnp.uint32(3),
                                     return_stats=True)
    o, d, t, rid = TI._pixel_rays(tcams[0], tc, torch.arange(n), 3)
    got, seg = TI.trace_rays(ts, tst, tc, o, d, t, rid, 3, return_stats=True)
    dseg, bad, mean = _flips(got.numpy(), np.asarray(ref), seg,
                             np.asarray(ref_seg))
    assert np.isfinite(got.numpy()).all()
    assert dseg <= max(4, n // 200)
    assert bad <= max(4, n // 100)
    assert mean < 5e-3
    img = TI.render_image(ts, tst, tc, tcams[0])
    assert img.shape == (16, 24, 3) and float(img.max()) > 0
