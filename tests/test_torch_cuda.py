"""The CUDA kernels against their plain torch versions, on a card.

Marked `gpu`: each test skips where torch sees no CUDA device, so on a
CPU-only host they count as skipped. Run them where there is a card with

    python -m pytest tests/test_torch_cuda.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from raytracer_weekend_tpu_torch import integrator, rng, textures
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models import scenes
from raytracer_weekend_tpu_torch.models.scenes import generate_scene
from raytracer_weekend_tpu_torch.ops.cuda import checks
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd
from raytracer_weekend_tpu_torch.scene.builder import build_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_device_rand4_bit_equal(cuda):
    ids = np.random.default_rng(4).integers(0, 2**32, size=65536, dtype=np.uint64)
    ids32 = torch.from_numpy(ids.astype(np.uint32).view(np.int32)).to(cuda)
    ids64 = torch.from_numpy(ids.astype(np.int64)).to(cuda)
    for salt in (rng.SALT_LENS, rng.SALT_METAL, rng.SALT_DIELECTRIC):
        for depth in (0, 3, 49):
            got = mk.rand4_device(ids32, depth, salt, 3)
            want = rng.rand4(3, ids64, depth, salt)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", ["two_spheres", "jumpy_balls"])
def test_kernel_matches_plain(cuda, name):
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=4, max_depth=6,
                       seed=3)
    scene, static, cams = generate_scene(name, cfg.aspect_ratio)
    scene, cam = scene.to(cuda), cams[0].to(cuda)
    n = cfg.n_rays
    before = mk.LAUNCHES
    got, seg = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static)
    assert mk.LAUNCHES == before + 1
    ref, ref_seg = mk.render_fused_reference(scene, cfg, cam, 0, n, cfg.seed,
                                             static=static)
    assert got.shape == (n, 3) and seg.dtype == torch.int32
    assert bool(torch.isfinite(got).all())
    # tests/test_megakernel.py:66-70 budgets.
    assert abs(int(seg.sum()) - int(ref_seg.sum())) <= max(4, n // 300)
    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 64)
    assert float((got - ref).abs().mean()) < 3e-3


def test_kernel_chunked_equals_whole(cuda):
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6,
                       seed=3)
    scene, static, cams = generate_scene("jumpy_balls", cfg.aspect_ratio)
    scene, cam = scene.to(cuda), cams[0].to(cuda)
    n = cfg.n_rays
    whole, wseg = mk.render_fused(scene, cfg, cam, 0, n, 3, static=static)
    a, aseg = mk.render_fused(scene, cfg, cam, 0, 1001, 3, static=static)
    b, bseg = mk.render_fused(scene, cfg, cam, 1001, n - 1001, 3, static=static)
    assert torch.equal(whole, torch.cat([a, b]))
    assert torch.equal(wseg, torch.cat([aseg, bseg]))


def test_render_image_launches_kernel(cuda):
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6,
                       seed=3, ray_batch=1000)
    scene, static, cams = generate_scene("two_spheres", cfg.aspect_ratio)
    before = mk.LAUNCHES
    img = integrator.render_image(scene.to(cuda), static, cfg,
                                  cams[0].to(cuda))
    assert mk.LAUNCHES == before + 3   # ceil(2304 / 1000) chunks
    assert img.shape == (18, 32, 3) and img.is_cuda


def test_unsupported_scene_on_cuda_raises(cuda):
    """The megakernel refuses a scene outside `fused_supported`;
    render_image renders it through the staged path on K10 instead."""
    from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as si

    cfg = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6)
    scene, static, cams = generate_scene("two_spheres", cfg.aspect_ratio)
    static = type(static)(**{**static.__dict__, "fused_simple": False})
    with pytest.raises(NotImplementedError):
        mk.render_fused(scene.to(cuda), cfg, cams[0].to(cuda), 0, 64, 0,
                        static=static)
    before = mk.LAUNCHES, si.LAUNCHES
    img = integrator.render_image(scene.to(cuda), static, cfg,
                                  cams[0].to(cuda))
    assert mk.LAUNCHES == before[0] and si.LAUNCHES == before[1] + 6
    assert img.shape == (18, 32, 3) and bool(torch.isfinite(img).all())


def scene_by_name(name, aspect):
    """A catalog scene (built on the card), or one of the test scenes of
    `models.scenes` (mesh_shards, sphere_medium, many_spheres, ...)."""
    if name not in scenes.SCENES:
        objs, cams, bg = getattr(scenes, name)(aspect)
        return (*build_scene(objs, background=bg), cams)
    return generate_scene(name, aspect)


def _frame(name, cuda, **size):
    kw = dict(width=64, height=36, samples_per_pixel=4, max_depth=6, seed=3)
    cfg = RenderConfig(**{**kw, **size})
    scene, static, cams = scene_by_name(name, cfg.aspect_ratio)
    return scene.to(cuda), static, cfg, cams[0].to(cuda)


@pytest.mark.parametrize("name", ["two_spheres", "jumpy_balls"])
def test_emit_kernel_matches_plain(cuda, name):
    """K1-emit: the codes ride along without touching radiance or segments,
    and agree with the plain version's but for near-tangent flips."""
    scene, static, cfg, cam = _frame(name, cuda)
    n = cfg.n_rays
    before = mk.EMIT_LAUNCHES
    rad, seg, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                      static=static, emit_paths=True)
    assert mk.EMIT_LAUNCHES == before + 1
    rad0, seg0 = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                 static=static)
    assert torch.equal(rad, rad0) and torch.equal(seg, seg0)
    assert codes.shape == (n, cfg.max_depth) and codes.dtype == torch.int32
    nz = (codes > 0).sum(1)
    assert bool(((nz == seg) | (nz == seg - 1)).all())
    _, _, ref = mk.render_fused_reference(scene, cfg, cam, 0, n, cfg.seed,
                                          static=static, emit_paths=True)
    assert int((codes != ref).any(1).sum()) <= max(4, n // 64)


def _agree(got, ref, norm_rel=1e-3, cos=0.9999, zero=1e-6):
    assert bool(torch.isfinite(got).all())
    top = float(ref.abs().max())
    if top == 0.0:
        return
    na = float(ref.norm())
    assert float((got - ref).norm()) / na <= norm_rel
    assert float((got * ref).sum()) / (na * float(got.norm())) >= cos
    # Entries that are zero in the reference stay (near) zero.
    assert float(torch.where(ref == 0, got.abs(), 0.0).max()) <= zero * top


@pytest.mark.parametrize("name", ["two_spheres", "jumpy_balls"])
def test_replay_bwd_kernel_matches_reference(cuda, name):
    """K2 against torch.autograd through the replay, on the kernel's own
    codes, g = 2 rad."""
    scene, static, cfg, cam = _frame(name, cuda)
    n = cfg.n_rays
    rad, _, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                    static=static, emit_paths=True)
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    ktab = replay_bwd.pack_ktab(scene)
    args = (ktab, None, scene.background, cfg, o, d, t, rid, cfg.seed, codes,
            2.0 * rad)
    before = replay_bwd.LAUNCHES
    got = replay_bwd.replay_bwd_fused(*args, n)
    assert replay_bwd.LAUNCHES == before + 1
    ref = replay_bwd.replay_bwd_reference(*args)
    assert got[1] is None and ref[1] is None
    for g_, r_ in zip(got, ref):
        if r_ is not None:
            assert g_.shape == r_.shape
            _agree(g_, r_)
    assert float(got[0].abs().max()) > 0 and float(got[5].abs().max()) > 0


def test_render_fused_diff_launches_both_kernels(cuda):
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff

    scene, static, cfg, cam = _frame("jumpy_balls", cuda, width=32, height=18)
    bg = scene.background.clone().requires_grad_()
    c1 = scene.textures.color1.clone().requires_grad_()
    scene = scene._replace(background=bg, textures=scene.textures._replace(
        color1=c1))
    k1, k2 = mk.EMIT_LAUNCHES, replay_bwd.LAUNCHES
    rad = render_fused_diff(scene, static, cfg, cam, 0, cfg.n_rays, cfg.seed)
    g_bg, g_c1 = torch.autograd.grad((rad * rad).sum(), (bg, c1))
    assert (mk.EMIT_LAUNCHES, replay_bwd.LAUNCHES) == (k1 + 1, k2 + 1)
    assert bool(torch.isfinite(g_c1).all()) and float(g_bg.abs().max()) > 0


def test_inverse_renderer_on_cuda(cuda):
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    scene, static, cfg, cam = _frame("two_spheres", cuda, width=16,
                                     height=12, samples_per_pixel=2,
                                     max_depth=4, ray_batch=200)
    target = integrator.render_image(scene, static, cfg, cam) / 2
    start = scene._replace(textures=scene.textures._replace(
        color1=scene.textures.color1 + 0.2))
    k1, k2 = mk.EMIT_LAUNCHES, replay_bwd.LAUNCHES
    _, hist = InverseRenderer(static, cfg, cam, target, learning_rate=0.05
                              ).fit(start, steps=3)
    # ceil(384 / 200) = 2 chunks per step, each through both kernels.
    assert (mk.EMIT_LAUNCHES, replay_bwd.LAUNCHES) == (k1 + 6, k2 + 6)
    assert hist[-1] < hist[0]


def test_replay_bwd_table_over_shared_memory_raises(cuda):
    """A d(ktab) that does not fit one block's shared memory (8,192
    spheres) no longer raises: K2 reduces it by global atomics. Lanes that
    all miss give the background's cotangent and an all-zero d(ktab)."""
    n, S = 8, 8192
    cfg = RenderConfig(width=4, height=2, samples_per_pixel=1, max_depth=2)
    z3 = torch.zeros((n, 3), device=cuda)
    before = replay_bwd.LAUNCHES
    dk, dp, d_o, d_d, d_t, d_bg = replay_bwd.replay_bwd_fused(
        torch.zeros((replay_bwd.KT, S), device=cuda), None,
        torch.zeros(3, device=cuda), cfg, z3, z3,
        torch.zeros(n, device=cuda), torch.arange(n, device=cuda), 0,
        torch.zeros((n, 2), dtype=torch.int32, device=cuda), z3 + 1.0, n)
    torch.cuda.synchronize()
    assert replay_bwd.LAUNCHES == before + 1
    assert dk.shape == (replay_bwd.KT, S) and not dk.any() and dp is None
    assert torch.equal(d_bg, torch.full((3,), float(n), device=cuda))


# ---- the planar family: K3 (forward) and K4 (backward) ---------------------

PLANAR = ["cornell_box", "mesh_shards", "simple_triangle"]


@pytest.mark.parametrize("name", PLANAR)
def test_planar_kernel_matches_plain(cuda, name):
    """K3 against the staged plain version, with the planar budgets of
    tests/test_megakernel.py:119-128 (|dseg| <= n//200, bad lanes <=
    n//100, mean abs < 1e-3): the kernel's affine plane test and the staged
    (k - o_f)/d_f and scalar-triple forms differ by rounding on edges."""
    scene, static, cfg, cam = _frame(name, cuda)
    n = cfg.n_rays
    before = mk.LAUNCHES, mk.PLANAR_LAUNCHES
    got, seg = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static)
    assert (mk.LAUNCHES, mk.PLANAR_LAUNCHES) == (before[0] + 1,
                                                 before[1] + 1)
    ref, ref_seg = mk.render_fused_reference(scene, cfg, cam, 0, n, cfg.seed,
                                             static=static)
    assert bool(torch.isfinite(got).all())
    assert abs(int(seg.sum()) - int(ref_seg.sum())) <= max(4, n // 200)
    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 100)
    assert float((got - ref).abs().mean()) < 1e-3
    rad, seg2, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                       static=static, emit_paths=True)
    assert torch.equal(rad, got) and torch.equal(seg2, seg)
    assert bool(((codes & 3) == 2).any())
    _, _, ref_codes = mk.render_fused_reference(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True)
    assert int((codes != ref_codes).any(1).sum()) <= max(4, n // 100)


@pytest.mark.parametrize("name", ["cornell_box", "mesh_shards",
                                  "wavefront_cow_obj"])
def test_planar_replay_bwd_kernel_matches_reference(cuda, name):
    """K4 against torch.autograd through the replay on the kernel's own
    codes, g = 2 rad, K2's budgets. The cow's table (5,805 rows) does not
    fit shared memory and takes the warp-aggregated global reduction."""
    size = dict(width=32, height=18) if name == "wavefront_cow_obj" else {}
    scene, static, cfg, cam = _frame(name, cuda, **size)
    n = cfg.n_rays
    rad, _, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                    static=static, emit_paths=True)
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    ktab = replay_bwd.pack_ktab(scene) if static.n_spheres else None
    ptab = replay_bwd.pack_ptab(scene, static)
    assert ptab.shape == (replay_bwd.KP, static.n_rects + static.n_triangles)
    args = (ktab, ptab, scene.background, cfg, o, d, t, rid, cfg.seed,
            codes, 2.0 * rad)
    before = replay_bwd.LAUNCHES, replay_bwd.PLANAR_LAUNCHES
    got = replay_bwd.replay_bwd_fused(*args, n)
    assert (replay_bwd.LAUNCHES, replay_bwd.PLANAR_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = replay_bwd.replay_bwd_reference(*args)
    for g_, r_ in zip(got, ref):
        assert (g_ is None) == (r_ is None)
        if r_ is not None:
            assert g_.shape == r_.shape
            _agree(g_, r_)
    assert float(got[1].abs().max()) > 0


@pytest.mark.parametrize("name", ["cornell_box", "wavefront_cow_obj"])
def test_render_image_launches_planar_kernel(cuda, name):
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=2, max_depth=4,
                       seed=3)
    scene, static, cams = generate_scene(name, cfg.aspect_ratio)
    before = mk.PLANAR_LAUNCHES
    img = integrator.render_image(scene.to(cuda), static, cfg,
                                  cams[0].to(cuda))
    assert mk.PLANAR_LAUNCHES == before + 1
    assert img.shape == (18, 32, 3) and bool(torch.isfinite(img).all())


def test_render_fused_diff_planar_launches_kernels(cuda):
    """cornell_box and the cow (d(ptab) by global atomics) go through
    K3-emit and K4; simple_triangle (uv-debug) through K3-emit and torch
    autograd of the replay."""
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff

    for name, k4 in (("cornell_box", 1), ("wavefront_cow_obj", 1),
                     ("simple_triangle", 0)):
        scene, static, cfg, cam = _frame(name, cuda, width=32, height=18)
        c1 = scene.textures.color1.clone().requires_grad_()
        scene = scene._replace(textures=scene.textures._replace(color1=c1))
        before = mk.PLANAR_LAUNCHES, replay_bwd.PLANAR_LAUNCHES
        rad = render_fused_diff(scene, static, cfg, cam, 0, cfg.n_rays,
                                cfg.seed)
        (g_c1,) = torch.autograd.grad((rad * rad).sum(), (c1,))
        assert (mk.PLANAR_LAUNCHES, replay_bwd.PLANAR_LAUNCHES) == (
            before[0] + 1, before[1] + k4)
        assert bool(torch.isfinite(g_c1).all()) and float(g_c1.abs().max()) > 0


# ---- deferred textures: K6a (records), K7 (backward), K8/K9 (turbulence) ----

DEFERRED = ["earth", "two_perlin_spheres", "simple_light"]


def _live_points(cuda, n, seed=1):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((rng.normal(size=(n, 3)) * 7).astype(np.float32))
    # Dead runs longer than a block, and scattered dead points in live runs.
    live = (rng.random(n) < 0.6) & ((np.arange(n) // 1000) % 3 != 1)
    return p.to(cuda), torch.from_numpy(live).to(cuda)


def test_turbulence_kernel_matches_plain(cuda):
    """K8 against perlin.turbulence: max abs <= 1e-5, dead points 0."""
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    scene, _, _ = generate_scene("two_perlin_spheres", 1.5)
    g, pm = scene.textures.perlin_grad, scene.textures.perlin_perm
    p, live = _live_points(cuda, 200_000)
    before = pt.TURB_LAUNCHES
    got = pt.turbulence(g, pm, p, 7, live)
    assert pt.TURB_LAUNCHES == before + 1
    ref = pt.turbulence_reference(g, pm, p, 7, live)
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got[~live] == 0).all()) and float(got[live].std()) > 0.05
    whole = pt.turbulence(g, pm, p)
    assert float((whole - pt.turbulence_reference(g, pm, p)).abs().max()) <= 1e-5


def test_turbulence_vjp_kernel_matches_plain(cuda):
    """K9 against torch autograd of the plain version, with a real live mask
    over 200 blocks: norm_rel <= 1e-4, and every dead point's d_p exactly 0
    though its cotangent is not."""
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    scene, _, _ = generate_scene("two_perlin_spheres", 1.5)
    g, pm = scene.textures.perlin_grad, scene.textures.perlin_perm
    p, live = _live_points(cuda, 51_200, seed=2)
    ct = torch.randn(p.shape[0], device=cuda)
    before = pt.TURB_VJP_LAUNCHES
    dg, dp = pt.turbulence_vjp(g, pm, p, ct, 7, live)
    assert pt.TURB_VJP_LAUNCHES == before + 1
    rg, rp = pt.turbulence_vjp_reference(g, pm, p, ct, 7, live)
    assert bool((dp[~live] == 0).all())
    for a, b in ((dg, rg), (dp, rp)):
        assert float((a - b).norm() / b.norm()) <= 1e-4


SPARSE_RAGGED = [
    (5, 1.0),                          # fewer points than a warp
    (3 * 256 + 17, 0.02),              # ragged windows, mostly dead
    (200_003, 0.02),                   # many windows, mostly dead
    (100_000, 0.0),                    # all dead
]


@pytest.mark.parametrize("n, share", SPARSE_RAGGED + [(70_001, 1.0)])
def test_turbulence_kernel_sparse_and_ragged(cuda, n, share):
    """K8's persistent warps (K9's claims and ballot packing) on masks that
    are mostly dead, all live, and on point counts that are no multiple of
    its block or window: each dead point exactly 0, each live one within
    1e-5 of the plain version, and the launch alone on operands built
    beforehand gives the call's values bit for bit, twice (the counter is
    zeroed by each launch)."""
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    scene, _, _ = generate_scene("two_perlin_spheres", 1.5)
    g, pm = scene.textures.perlin_grad, scene.textures.perlin_perm
    rng = np.random.default_rng(n)
    p = torch.from_numpy((rng.normal(size=(n, 3)) * 7).astype(np.float32))
    live = torch.from_numpy(rng.random(n) < share)
    p, live = p.to(cuda), live.to(cuda)
    before = pt.TURB_LAUNCHES
    got = pt.turbulence(g, pm, p, 7, live)
    assert pt.TURB_LAUNCHES == before + 1
    ref = pt.turbulence_reference(g, pm, p, 7, live)
    assert bool((got[~live] == 0).all()) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5
    ops = pt.turbulence_operands(g, pm, p, live)
    assert torch.equal(pt._launch_turbulence(ops), got)
    assert torch.equal(pt._launch_turbulence(ops), got)
    assert pt.TURB_LAUNCHES == before + 1


@pytest.mark.parametrize("n, share", SPARSE_RAGGED)
def test_turbulence_vjp_kernel_sparse_and_ragged(cuda, n, share):
    """K9's persistent warps on masks that are mostly dead and on point
    counts that are no multiple of its block or window: each dead point's
    d_p exactly 0, each live point's within norm_rel 1e-4 of the plain
    version (as d_grad), and the launch alone on operands built beforehand
    gives the call's d_p bit for bit."""
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    scene, _, _ = generate_scene("two_perlin_spheres", 1.5)
    g, pm = scene.textures.perlin_grad, scene.textures.perlin_perm
    rng = np.random.default_rng(n)
    p = torch.from_numpy((rng.normal(size=(n, 3)) * 7).astype(np.float32))
    live = torch.from_numpy(rng.random(n) < share)
    p, live = p.to(cuda), live.to(cuda)
    ct = torch.randn(n, device=cuda)
    before = pt.TURB_VJP_LAUNCHES
    dg, dp = pt.turbulence_vjp(g, pm, p, ct, 7, live)
    assert pt.TURB_VJP_LAUNCHES == before + 1
    rg, rp = pt.turbulence_vjp_reference(g, pm, p, ct, 7, live)
    assert bool((dp[~live] == 0).all()) and bool(torch.isfinite(dp).all())
    for a, b in ((dg, rg), (dp, rp)):
        if bool(live.any()):
            assert float((a - b).norm() / b.norm()) <= 1e-4
        else:
            assert not a.any()
    ops = pt.vjp_operands(g, pm, p, ct, live)
    assert torch.equal(pt._launch_vjp(ops)[1], dp)
    assert torch.equal(pt._launch_vjp(ops)[1], dp)    # the counter re-zeroed
    assert pt.TURB_VJP_LAUNCHES == before + 1


def test_deferred_replay_bwd_lane_order(cuda):
    """K7 on two_perlin_spheres at 64x36x4 d6 with the combine's real
    cotangents: the same lanes handed over in another order (the plain twin
    of its sweep order, and that reversed) give every lane's d_o, d_d and
    d_time bit for bit at the lane's own index, and the table and
    background cotangents within 1e-5 of each other; against its plain
    version with K2's budgets, the lanes held out as in
    test_deferred_replay_bwd_kernel_matches_reference."""
    from raytracer_weekend_tpu_torch import fused_diff

    scene, static, cfg, cam = _frame("two_perlin_spheres", cuda)
    n = cfg.n_rays
    rad, _, codes, *recs = mk.render_fused(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True,
        emit_deferred=True)
    g, cabc, _ = fused_diff.combine_vjp(scene, static, recs, 2.0 * rad, [])
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    ktab = replay_bwd.pack_ktab(scene)

    def k7(perm, g_=g, c_=cabc):
        return replay_bwd.replay_bwd_fused(
            ktab, None, scene.background, cfg, o[perm], d[perm], t[perm],
            rid[perm], cfg.seed, codes[perm], g_[perm], n, cabc=c_[perm])

    ident = torch.arange(n, device=cuda)
    ref = k7(ident)
    sweep = replay_bwd.sweep_order(codes, static.n_spheres, 0)
    for perm in (sweep, sweep.flip(0)):
        got = k7(perm)
        for k in (2, 3, 4):
            back = torch.empty_like(got[k])
            back[perm] = got[k]
            assert torch.equal(back, ref[k])
        for k in (0, 5):
            assert float((got[k] - ref[k]).norm()) <= \
                1e-5 * float(ref[k].norm())
    assert float(ref[2].abs().max()) > 0     # noise records reach the rays

    def plain(g_, c_, dtype=torch.float32, rays=(o, d)):
        def cast(x):
            return None if x is None else x.to(dtype)
        return replay_bwd.replay_bwd_reference(
            cast(ktab), None, cast(scene.background), cfg, *map(cast, rays),
            cast(t), rid, cfg.seed, codes, cast(g_), cast(c_))

    wit = plain(g, cabc, torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(6)
    jit = tuple(x.double() * (1.0 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, x.shape, device=cuda, generator=gen) - 1)) for x in (o, d))
    held = ((codes != _float64_codes(scene, static, cfg, o, d, t, rid)).any(1)
            | _ill(plain(g, cabc), wit)
            | _ill(plain(g, cabc, torch.float64, jit), wit))
    assert int(held.sum()) <= max(4, n // 100)
    keep = (~held).to(g.dtype)[:, None, None]
    got = k7(ident, g * keep, cabc * keep)
    for r in (plain(g * keep, cabc * keep),
              plain(g * keep, cabc * keep, torch.float64)):
        for g_, r_ in zip(got, r):
            if r_ is not None:
                _agree(g_.double(), r_.double())


@pytest.mark.parametrize("name", DEFERRED)
def test_deferred_kernel_matches_plain(cuda, name):
    """K6a: the records and the combined radiance against the plain version
    (the staged path with deferred records), with the budgets of
    tests/test_megakernel.py:322-328, segments n // 200 included: the
    forward kernel's sphere test (K1's, which K6a shares: the segments equal
    those of the same geometry with solid textures) keeps |o|^2 - 2 o.c
    apart from |c|^2 - r^2, so rays leaving the radius-1000 ground no longer
    re-hit it (they did on ~0.3% of lanes when it computed o - c first,
    and the budget was n // 50 until then). The kernel's and the staged hit
    points differ by rounding (most on that ground), so a budget of records
    may differ beyond 1e-3."""
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    scene, static, cfg, cam = _frame(name, cuda)
    n = cfg.n_rays
    before = mk.DEFER_LAUNCHES, pt.TURB_LAUNCHES
    rad, seg, codes, ctb, abc, dcode = mk.render_fused(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True,
        emit_deferred=True)
    assert mk.DEFER_LAUNCHES == before[0] + 1
    assert pt.TURB_LAUNCHES == before[1] + int(static.has_noise
                                                and not static.defer_single_hit)
    r_rad, r_seg, r_codes, r_ctb, r_abc, r_dcode = mk.render_fused_reference(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True,
        emit_deferred=True)
    assert bool(torch.isfinite(rad).all())
    assert abs(int(seg.sum()) - int(r_seg.sum())) <= max(4, n // 200)
    solid = scene._replace(textures=scene.textures._replace(
        ttype=torch.zeros_like(scene.textures.ttype)))
    _, s_seg = mk.render_fused(solid, cfg, cam, 0, n, cfg.seed, static=type(
        static)(**{**static.__dict__, "has_noise": False, "has_image": False}))
    assert torch.equal(seg, s_seg)
    rel = (rad - r_rad).abs() / (r_rad.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 100)
    assert float((rad - r_rad).abs().mean()) < 5e-3
    same = (codes == r_codes).all(dim=1)
    assert int((~same).sum()) <= max(4, n // 100)
    assert torch.equal(dcode[same], r_dcode[same])
    live = (dcode != 0) & same[:, None]
    assert int(live.sum()) > n // 4
    # Measured (64x36x16 d8, chip_smoke phase 9): 0.05% (earth) to 1.6%
    # (simple_light) of the records beyond 1e-4, up to 212 units apart on
    # far grazing ground hits.
    far = ~torch.isclose(abc[live], r_abc[live], rtol=1e-3, atol=1e-3).all(-1)
    assert int(far.sum()) <= max(4, int(live.sum()) // 50)
    assert bool((abc[dcode == 0] == 0).all())
    assert int((~torch.isclose(ctb[same], r_ctb[same], rtol=1e-4,
                               atol=1e-4)).any(-1).any(-1).sum()) <= max(
        4, n // 100)
    # The records ride along: the launch without codes gives the same.
    rad0, seg0 = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                 static=static)
    assert torch.equal(rad0, rad) and torch.equal(seg0, seg)


def _float64_codes(scene, static, cfg, o, d, t, rid):
    """The staged path's winner codes traced in float64 from the rays."""
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    import dataclasses

    scene64 = SceneData.from_leaves(
        [le.double() if le.is_floating_point() else le
         for le in scene.leaves()], scene.trees)
    cfg = dataclasses.replace(cfg, use_pallas=False)   # the plain brute force
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return integrator.trace_lanes(
            scene64, static, cfg, o.double(), d.double(), t.double(), rid,
            cfg.seed, emit_paths=True, emit_deferred=mk.defers(static))[2]
    finally:
        torch.set_default_dtype(prev)


def _lane_outputs(r):
    return torch.cat([r[2].double(), r[3].double(), r[4].double()[:, None]],
                     dim=1)


def _ill(ref, wit, rel=1e-4):
    """Lanes whose d_o, d_d, d_time `ref` gives more than `rel` of the
    lane's largest entry away from the float64 witness `wit`."""
    w = _lane_outputs(wit)
    top = w.abs().amax(dim=1)
    err = (_lane_outputs(ref) - w).abs().amax(dim=1)
    return err > rel * top + 1e-6 * float(top.max())


@pytest.mark.parametrize("name", DEFERRED)
def test_deferred_replay_bwd_kernel_matches_reference(cuda, name):
    """K7 against torch autograd of the replay's deferred form on the
    kernel's own codes, random per-bounce cotangents g and, for noise
    scenes, random hit-point cotangents cabc on the noise records; K2's
    budgets against the plain version in float32 and in float64. Held out
    (cotangents zeroed), at most n // 100 lanes: those whose codes the
    float64 staged path does not reproduce (hits within rounding of
    tangency, the forward kernel's re-hits of the ground: ROADMAP Queue 3),
    and those whose float64 gradient moves by more than 1e-4 of the lane's
    largest entry when its rays move by one float32 ulp, or from which the
    float32 plain version is that far (1/sqrt(disc) of nearly tangent
    rays amplifies float32 rounding; chip_smoke.py phase 10 does the same
    at full size)."""
    scene, static, cfg, cam = _frame(name, cuda)
    n, D = cfg.n_rays, cfg.max_depth
    _, _, codes, _, _, dcode = mk.render_fused(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True,
        emit_deferred=True)
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    ktab = replay_bwd.pack_ktab(scene) if static.n_spheres else None
    ptab = (replay_bwd.pack_ptab(scene, static)
            if static.n_rects + static.n_triangles else None)
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = torch.randn((n, D, 3), device=cuda, generator=gen)
    cabc = None
    if static.has_noise:
        tid = (dcode.abs() - 1).clamp_min(0).long()
        noise = (dcode != 0) & (scene.textures.ttype[tid] == textures.NOISE)
        cabc = torch.randn((n, D, 3), device=cuda, generator=gen) * \
            noise[..., None]

    def plain(g_, c_, dtype=torch.float32, rays=(o, d)):
        def cast(x):
            return None if x is None else x.to(dtype)
        return replay_bwd.replay_bwd_reference(
            cast(ktab), cast(ptab), cast(scene.background), cfg,
            *map(cast, rays), cast(t), rid, cfg.seed, codes, cast(g_),
            cast(c_))

    wit = plain(g, cabc, torch.float64)
    jit = tuple(x.double() * (1.0 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, x.shape, device=cuda, generator=gen) - 1)) for x in (o, d))
    held = ((codes != _float64_codes(scene, static, cfg, o, d, t, rid)).any(1)
            | _ill(plain(g, cabc), wit)
            | _ill(plain(g, cabc, torch.float64, jit), wit))
    assert int(held.sum()) <= max(4, n // 100)
    keep = (~held).to(g.dtype)[:, None, None]
    g = g * keep
    cabc = None if cabc is None else cabc * keep
    before = replay_bwd.DEFER_LAUNCHES
    got = replay_bwd.replay_bwd_fused(ktab, ptab, scene.background, cfg, o, d,
                                      t, rid, cfg.seed, codes, g, n,
                                      cabc=cabc)
    assert replay_bwd.DEFER_LAUNCHES == before + 1
    for ref in (plain(g, cabc), plain(g, cabc, torch.float64)):
        for g_, r_ in zip(got, ref):
            assert (g_ is None) == (r_ is None)
            if r_ is not None:
                assert g_.shape == r_.shape
                _agree(g_.double(), r_.double())
    assert float(got[5].abs().max()) > 0
    if static.has_noise:
        assert float(got[2].abs().max()) > 0    # d_o through the hit points


@pytest.mark.parametrize("name", DEFERRED)
def test_render_fused_diff_deferred_launches_kernels(cuda, name):
    """render_fused_diff on a deferring scene goes through K6a (with K8 for
    noise) forward and K9 (noise) and K7 backward, and its gradients are
    finite and reach the texture table."""
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt

    scene, static, cfg, cam = _frame(name, cuda, width=32, height=18)
    images = scene.textures.images.clone().requires_grad_()
    pg = scene.textures.perlin_grad.clone().requires_grad_()
    scene = scene._replace(textures=scene.textures._replace(
        images=images, perlin_grad=pg))
    before = (mk.DEFER_LAUNCHES, replay_bwd.DEFER_LAUNCHES,
              pt.TURB_VJP_LAUNCHES)
    rad = render_fused_diff(scene, static, cfg, cam, 0, cfg.n_rays, cfg.seed)
    g_img, g_pg = torch.autograd.grad((rad * rad).sum(), (images, pg))
    noise = int(static.has_noise)
    assert (mk.DEFER_LAUNCHES, replay_bwd.DEFER_LAUNCHES,
            pt.TURB_VJP_LAUNCHES) == (before[0] + 1, before[1] + 1,
                                      before[2] + noise)
    assert bool(torch.isfinite(g_img).all() and torch.isfinite(g_pg).all())
    assert float(g_img.abs().max()) > 0 or not static.has_image
    assert float(g_pg.abs().max()) > 0 or not static.has_noise


# ---- constant-density media (K5) and the depth-phased render (K6b) --------

MEDIA = ["smokey_cornell_box", "sphere_medium"]


@pytest.mark.parametrize("name", MEDIA)
@pytest.mark.parametrize("log10", [True, False])
def test_volume_kernel_matches_plain(cuda, name, log10):
    """K5 against its plain version (the staged path with media) with the
    budgets of tests/test_megakernel.py:214-258, for both values of the
    log10 flag; K5-emit's radiance and segments are K5's bit for bit and
    its codes name both media."""
    import dataclasses

    scene, static, cfg, cam = _frame(name, cuda)
    cfg = dataclasses.replace(cfg, use_log10_volume_sampling=log10)
    n = cfg.n_rays
    before = mk.VOL_LAUNCHES
    rad, seg = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static)
    erad, eseg, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                        static=static, emit_paths=True)
    assert mk.VOL_LAUNCHES == before + 2
    ref, ref_seg, rcodes = mk.render_fused_reference(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True)
    assert torch.equal(erad, rad) and torch.equal(eseg, seg)
    assert bool(torch.isfinite(rad).all())
    assert abs(int(seg.sum()) - int(ref_seg.sum())) <= max(4, n // 200)
    rel = (rad - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 100)
    assert float((rad - ref).abs().mean()) < 1e-3
    vol = codes[(codes & 3) == 3] >> 2
    assert set(vol.unique().tolist()) == set(range(static.n_volumes))
    assert int((codes != rcodes).any(1).sum()) <= max(4, n // 100)


@pytest.mark.parametrize("name, emit", [("smokey_cornell_box", False),
                                        ("smokey_cornell_box", True),
                                        ("sphere_medium", True),
                                        ("book2_final_scene", True)])
def test_media_launch_windows_bitwise(cuda, name, emit):
    """K5 and K5-emit (and K6a's records on book2) on media_kernel: a
    window larger than the card's resident lane slots, its halves and a
    window of 5 lanes give the same lanes bit for bit (codes and records
    included), one VOL_LAUNCHES count a launch."""
    size = (dict(width=160, height=90) if name == "book2_final_scene"
            else dict(width=400, height=225))
    scene, static, cfg, cam = _frame(name, cuda, samples_per_pixel=4,
                                     max_depth=6, **size)
    n = cfg.n_rays
    R = static.n_rects + static.n_triangles
    assert mk.fused_kernel(R, static.n_volumes, phase=False) == \
        "media_kernel"
    tables = mk.build_tables(scene, static, cam)

    def run(start=0, count=n):
        return mk._launch(scene, cfg, cam, start, count, cfg.seed, static,
                          emit_paths=emit, tables=tables)

    before = mk.VOL_LAUNCHES
    whole = run()
    assert mk.VOL_LAUNCHES == before + 1
    if name != "book2_final_scene":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert n > mk.resident_blocks(static, cuda, phase=False) * sms * \
            mk.MEDIA_BLOCK
    h = n // 2 + 37
    for a, b, w in zip(run(start=0, count=h), run(start=h, count=n - h),
                       whole):
        assert torch.equal(torch.cat([a, b]), w)
    for a, w in zip(run(start=1001, count=5), whole):
        assert torch.equal(a, w[1001:1006])
    assert bool(torch.isfinite(whole[0]).all())
    if emit:
        assert bool(((whole[2] & 3) == 3).any())


@pytest.mark.parametrize("name, depth", [("book2_final_scene", 20),
                                         ("jumpy_balls", 20)])
def test_deep_render_matches_single_pass(cuda, name, depth):
    """K6b: the depth-phased render (phases of 10 bounces, live lanes
    gathered between them) gives the single-pass launch's lanes bit for
    bit; render_image takes it for a whole frame at depth 16+."""
    scene, static, cfg, cam = _frame(name, cuda, width=40, height=22,
                                     samples_per_pixel=4, max_depth=depth)
    n = cfg.n_rays
    live = []
    before = mk.PHASE_LAUNCHES
    rad_d, seg_d = mk.render_fused_deep(scene, cfg, cam, 0, n, cfg.seed,
                                        static=static, live_counts=live)
    assert mk.PHASE_LAUNCHES == before + 2
    rad_s, seg_s = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                   static=static, deep=False)
    assert torch.equal(rad_d, rad_s) and torch.equal(seg_d, seg_s)
    assert 0 < live[0] < n
    before = mk.PHASE_LAUNCHES
    img = integrator.render_image(scene, static, cfg, cam)
    assert mk.PHASE_LAUNCHES == before + 2
    want = rad_s.reshape(cfg.n_pixels, cfg.samples_per_pixel, 3).sum(1)
    assert torch.equal(img.reshape(-1, 3), want)


def test_render_fused_diff_medium_launches_k5(cuda):
    """A medium scene's forward+backward: K5-emit forward, torch autograd of
    the replay backward (no K2/K4/K7 launch); the albedo gradients are
    finite and nonzero, the media's boundary gradients exactly 0."""
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff

    scene, static, cfg, cam = _frame("smokey_cornell_box", cuda, width=32,
                                     height=18)
    c1 = scene.textures.color1.clone().requires_grad_()
    off = scene.volumes.offset.clone().requires_grad_()
    scene = scene._replace(textures=scene.textures._replace(color1=c1),
                           volumes=scene.volumes._replace(offset=off))
    before = (mk.VOL_LAUNCHES, mk.EMIT_LAUNCHES, replay_bwd.LAUNCHES)
    rad = render_fused_diff(scene, static, cfg, cam, 0, cfg.n_rays, cfg.seed)
    g_c1, g_off = torch.autograd.grad((rad * rad).sum(), (c1, off))
    assert (mk.VOL_LAUNCHES, mk.EMIT_LAUNCHES, replay_bwd.LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    assert bool(torch.isfinite(g_c1).all()) and float(g_c1.abs().max()) > 0
    assert not g_off.any()


# ---- the redesigned K3 (planar tiles, prefilter) and K6b (lane groups) ------

@pytest.mark.parametrize("t_min", checks.CAND_T_MINS)
def test_plane_candidate_kernel_contains_exact(cuda, t_min):
    """The kernel's division-free planar prefilter passes every row the
    exact test accepts, on the adversarial set and 2^20 random cases, and
    gives its plain twin's bits."""
    num, den, best = (torch.from_numpy(x).to(cuda) for x in
                      checks.candidate_cases(t_min, 1 << 20, seed=4))
    got = mk.plane_candidate_device(num, den, best, t_min)
    exact = checks.exact_accepts(num, den, best, t_min)
    assert int((exact & ~got).sum()) == 0 and int(exact.sum()) > 10_000
    twin = mk.plane_candidate_plain(num.cpu(), den.cpu(), t_min, best.cpu())
    assert torch.equal(got.cpu(), twin)


def test_planar_kernel_many_tiles_matches_plain(cuda):
    """The cow's 5,805 planar rows span twelve shared-memory tiles: K3 and
    K3-emit against the plain version with the planar budgets."""
    scene, static, cfg, cam = _frame("wavefront_cow_obj", cuda, width=32,
                                     height=18, samples_per_pixel=2,
                                     max_depth=4)
    n = cfg.n_rays
    got, seg = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static)
    ref, ref_seg = mk.render_fused_reference(scene, cfg, cam, 0, n, cfg.seed,
                                             static=static)
    assert abs(int(seg.sum()) - int(ref_seg.sum())) <= max(4, n // 200)
    rel = (got - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 100)
    rad, seg2, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                       static=static, emit_paths=True)
    assert torch.equal(rad, got) and torch.equal(seg2, seg)
    assert bool(((codes & 3) == 2).any())


@pytest.mark.parametrize("name", ["book2_final_scene", "jumpy_balls"])
def test_deep_render_groups_match_single_pass(cuda, name):
    """K6b with G lanes per ray, G forced to each of 1, 2, ..., 32 and
    chosen from the live lanes: bitwise the single pass."""
    scene, static, cfg, cam = _frame(name, cuda, width=40, height=22,
                                     samples_per_pixel=4, max_depth=20)
    n = cfg.n_rays
    want = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static,
                           deep=False)
    for g in (*mk.GROUPS, None):
        phases = []
        got = mk._render_deep(scene, cfg, cam, 0, n, cfg.seed, static=static,
                              group=g, phases=phases)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), g
        assert all(ph["group"] == (g or ph["group"]) for ph in phases)
    # A few live lanes take the most lanes per ray.
    assert phases[-1]["group"] == mk.GROUPS[-1]
    with pytest.raises(ValueError):
        mk._launch(scene, cfg, cam, 0, n, cfg.seed, static, phase=True,
                   group=3)



@pytest.mark.parametrize("name", ["book2_final_scene", "smokey_cornell_box"])
def test_deep_render_refill_matches(cuda, name):
    """K6b's phased launches with media at one lane a ray on media_kernel
    (slots refilled as lanes die): at depth 50 with G forced to 1, bitwise
    the single pass, and the same phased render kept on render_kernel; each
    phase launched again from its inputs on either kernel gives the same
    radiance, segments, records and state; `refill_lane_bounces` counts
    every refill launch's lanes x bounces and REFILL_LAUNCHES its launches,
    and nothing on render_kernel; no launch takes a kernel its route does
    not allow."""
    from raytracer_weekend_tpu_torch.utils import metrics

    scene, static, cfg, cam = _frame(name, cuda, width=40, height=22,
                                     samples_per_pixel=4, max_depth=50)
    n = cfg.n_rays
    want = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static,
                           deep=False)
    runs = {}
    for refill in (True, False):
        phases = []
        mk.REFILL_LAUNCHES = 0
        metrics.reset_counters()
        with metrics.tracing():
            got = mk._render_deep(scene, cfg, cam, 0, n, cfg.seed,
                                  static=static, group=1, phases=phases,
                                  refill=refill)
        counts = metrics.counters()
        metrics.reset_counters()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), refill
        assert len(phases) >= 2
        kernel = "media_kernel" if refill else "render_kernel"
        assert all(ph["kernel"] == kernel for ph in phases)
        bounces = sum(ph["lanes"] * ph["cfg"].max_depth for ph in phases)
        assert counts["phase_lane_bounces"] == bounces
        assert counts.get("refill_lane_bounces", 0) == (bounces if refill
                                                        else 0)
        assert mk.REFILL_LAUNCHES == (len(phases) if refill else 0)
        runs[refill] = phases
    tables = mk.build_tables(scene, static, cam)
    for ph in runs[True]:
        a, b = (mk._launch(scene, ph["cfg"], cam, 0, ph["lanes"], cfg.seed,
                           static, phase=True, state=ph["state"],
                           lanes=ph["ids"], d0=ph["d0"], tables=tables,
                           group=1, kernel=kernel)
                for kernel in ("media_kernel", "render_kernel"))
        assert len(a) == len(b) == (6 if mk.defers(static) else 3)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), ph["d0"]
    ph = runs[True][-1]
    for group, kernel in ((2, "media_kernel"), (1, "sphere_kernel")):
        with pytest.raises(ValueError):
            mk._launch(scene, ph["cfg"], cam, 0, ph["lanes"], cfg.seed,
                       static, phase=True, state=ph["state"],
                       lanes=ph["ids"], d0=ph["d0"], tables=tables,
                       group=group, kernel=kernel)


@pytest.mark.parametrize("name", ["book2_final_scene", "smokey_cornell_box"])
def test_deep_render_refills_at_one_lane_a_ray(cuda, name):
    """The automatic phased render of a frame whose first phase fills the
    card's resident threads: its launches at G = 1 take media_kernel, those
    at G > 1 render_kernel, and the frame is the single pass bit for
    bit."""
    scene, static, cfg, cam = _frame(name, cuda, width=400, height=225,
                                     samples_per_pixel=2, max_depth=50)
    n = cfg.n_rays
    assert n >= mk.resident_threads(static, cuda)
    phases = []
    got = mk._render_deep(scene, cfg, cam, 0, n, cfg.seed, static=static,
                          phases=phases)
    want = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static,
                           deep=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert phases[0]["group"] == 1 and phases[-1]["group"] > 1
    for ph in phases:
        assert ph["kernel"] == ("media_kernel" if ph["group"] == 1
                                else "render_kernel")

# ---- the redesigned sphere-only single pass (persistent warps) ---------------

@pytest.mark.parametrize("name, emit", [("jumpy_balls", False),
                                        ("jumpy_balls", True),
                                        ("two_perlin_spheres", False)])
def test_sphere_launch_windows_bitwise(cuda, name, emit):
    """K1, K1-emit and K6a (persistent warps claiming lanes from a
    per-launch counter): a window larger than the card's resident lane
    slots, its halves at n // 2 + 37, a window of 5 lanes and the same
    launch again on one stream give the same lanes bit for bit; the
    records come back as views of one 32-byte row a record."""
    scene, static, cfg, cam = _frame(name, cuda, width=400, height=225,
                                     samples_per_pixel=4, max_depth=6)
    n = cfg.n_rays
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    slots = (mk.resident_blocks(static, cuda, phase=False) * sms
             * mk.SPHERE_BLOCK * mk.SPHERE_RAYS)
    assert static.n_rects + static.n_triangles + static.n_volumes == 0
    assert n > slots

    def run(start, count):
        return mk.render_fused_records(scene, cfg, cam, start, count,
                                       cfg.seed, static=static,
                                       emit_paths=emit)

    whole = run(0, n)
    h = n // 2 + 37
    for a, b, w in zip(run(0, h), run(h, n - h), whole):
        assert torch.equal(torch.cat([a, b]), w)
    for a, w in zip(run(1001, 5), whole):
        assert torch.equal(a, w[1001:1006])
    for a, w in zip(run(0, n), whole):
        assert torch.equal(a, w)
    if mk.defers(static):
        ctb, abc, dcode = whole[-3:]
        assert ctb.shape == abc.shape == (n, cfg.max_depth, 3)
        assert dcode.shape == (n, cfg.max_depth) and dcode.dtype == torch.int32
        assert ctb.stride() == abc.stride() == (8 * cfg.max_depth, 8, 1)
        assert int((dcode != 0).sum()) > n // 2


@pytest.mark.parametrize("name", ["many_spheres", "jumpy_balls"])
def test_sphere_launch_table_paths(cuda, name):
    """The packed rows resident in shared memory and read from global
    memory give the same lanes bit for bit: many_spheres' 3,970 rows (above
    SPHERE_ROW_LIMIT: global by default, 190 KB forced resident) and
    jumpy_balls' 486 (resident by default)."""
    scene, static, cfg, cam = _frame(name, cuda)
    n = cfg.n_rays
    tables = mk.build_tables(scene, static, cam)
    outs = [mk._launch(scene, cfg, cam, 0, n, cfg.seed, static,
                       emit_paths=True, tables=tables, resident=r)
            for r in (None, True, False)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a, b)
    assert (static.n_spheres > mk.SPHERE_ROW_LIMIT) == (name == "many_spheres")
    assert bool(torch.isfinite(outs[0][0]).all())


# ---- the staged path: K10, K11, K12 and K2's global d(ktab) ----------------

@pytest.mark.parametrize("kind", ["spheres", "rects", "triangles"])
def test_closest_hit_kernel_matches_plain(cuda, kind):
    """K10, K11 and K12 against the plain brute force on random tables,
    with phase 14's budgets; a float64 operand raises on the card."""
    from raytracer_weekend_tpu_torch.ops import rect, sphere, triangle
    from raytracer_weekend_tpu_torch.ops.cuda import (
        rect_intersect, sphere_intersect, triangle_intersect)

    mod, kern, plain = {
        "spheres": (sphere_intersect, sphere_intersect.hit_spheres_kernel,
                    sphere.hit_spheres),
        "rects": (rect_intersect, rect_intersect.hit_rects_kernel,
                  rect.hit_rects),
        "triangles": (triangle_intersect,
                      triangle_intersect.hit_triangles_kernel,
                      triangle.hit_triangles)}[kind]
    tab, (o, d, time) = checks.random_hit_case(kind, cuda, 1 << 16)
    args = (o, d, time) if kind == "spheres" else (o, d)
    before = mod.LAUNCHES
    t_k, i_k = kern(tab, *args, 1e-3)
    assert mod.LAUNCHES == before + 1 and i_k.dtype == torch.int32
    t_p, i_p = plain(tab, *args, 1e-3)
    torch.cuda.synchronize()
    stats = checks.hit_budgets(t_k, i_k, t_p, i_p)
    assert stats["ok"], stats
    assert o.shape[0] // 20 < stats["hits"] < o.shape[0]
    with pytest.raises(ValueError, match="float32"):
        kern(tab, *(a.double() for a in args), 1e-3)


@pytest.mark.parametrize("kind", ["spheres", "rects", "triangles"])
def test_closest_hit_ragged_tiles_match_plain(cuda, kind):
    """K10, K11 and K12 bit for bit the plain brute force where the rays do
    not fill the last block and the table fills one tile, several tiles and
    a ragged last one; K12's counting launch finds that some pairs divide,
    and few; a table of another layout or off a 16-byte boundary raises."""
    from raytracer_weekend_tpu_torch.ops import rect, sphere, triangle
    from raytracer_weekend_tpu_torch.ops.cuda import rect_intersect as ri
    from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as si
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti

    mod = {"spheres": si, "rects": ri, "triangles": ti}[kind]
    full, (o, d, time) = checks.random_hit_case(
        kind, cuda, (1 << 15) + 77,
        rows=4 * mod.TILE if kind == "rects" else None)
    for rows in (mod.TILE // 2, mod.TILE, 3 * mod.TILE + 5):
        tab = full._replace(**{k: v[:rows] for k, v in full._asdict().items()})
        if kind == "spheres":
            table, ops = si.sphere_table(tab), si.ray_operands(o, d, time)
            want = sphere.hit_spheres(tab, o, d, time, 1e-3)
        elif kind == "rects":
            table, ops = ri.rect_table(tab), ri.ray_operands(o, d)
            want = rect.hit_rects(tab, o, d, 1e-3)
        else:
            table, ops = ti.triangle_table(tab), ti.ray_operands(o, d)
            want = triangle.hit_triangles(tab, o, d, 1e-3)
        t, idx = mod._launch(table, ops, 1e-3)
        assert torch.equal(t, want[0]) and torch.equal(idx.long(), want[1])
        assert int(torch.isfinite(t).sum()) > 100, rows
    if kind == "triangles":
        divides = ti.count_divisions(table, ops, 1e-3)
        pairs = o.shape[0] * int(tab.valid.sum())
        assert 0 < divides < pairs // 10
    with pytest.raises(ValueError, match="table"):
        mod._launch(table[:, :-1].contiguous(), ops, 1e-3)
    with pytest.raises(ValueError, match="table"):
        mod._launch(table.reshape(-1)[1:1 + table.numel() - table.shape[1]]
                    .view(-1, table.shape[1]), ops, 1e-3)


@pytest.mark.parametrize("t_min", [1e-3, 7.0, 0.0, -0.5])
def test_rect_kernel_many_tiles_match_plain_and_twin(cuda, t_min):
    """K11 on 1,000 random rects (8 tiles: walk_tiles' double buffer), at
    t_min above and at or below 0, bit for bit its plain version and its
    plain twin (`hit_rects_twin`, on the CPU, the first 4,096 rays)."""
    from raytracer_weekend_tpu_torch.ops import rect
    from raytracer_weekend_tpu_torch.ops.cuda import rect_intersect as ri

    tab, (o, d, _) = checks.random_hit_case("rects", cuda, 1 << 16,
                                            rows=1000)
    assert tab.k.shape[0] > 4 * ri.TILE
    table, ops = ri.rect_table(tab), ri.ray_operands(o, d)
    t, idx = ri._launch(table, ops, t_min)
    want_t, want_i = rect.hit_rects(tab, o, d, t_min)
    assert torch.equal(t, want_t) and torch.equal(idx.long(), want_i)
    cpu = type(tab)(*(x.cpu() for x in tab))
    tw_t, tw_i = ri.hit_rects_twin(cpu, o[:4096].cpu(), d[:4096].cpu(),
                                   t_min)
    assert torch.equal(t[:4096].cpu(), tw_t)
    assert torch.equal(idx[:4096].cpu(), tw_i)
    if t_min < 7.0:
        assert int(torch.isfinite(t).sum()) > o.shape[0] // 2


@pytest.mark.parametrize("name", ["jumpy_balls_uvdebug", "cornell_box",
                                  "wavefront_cow_obj"])
def test_prebuilt_tables_on_card(cuda, name, monkeypatch):
    """The staged path on the card, each family's table built once a trace
    (`integrator.kernel_tables`), gives the radiance and segments of the
    Functions building their own table at every launch, bit for bit; and a
    vertex (or, without triangles, a sphere radius) changed in place
    between two traces reaches the second, which equals a trace of a fresh
    copy of the changed scene."""
    import dataclasses

    from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as si
    from raytracer_weekend_tpu_torch.scene.data import SceneData

    scene, static, cfg, cam = _frame(name, cuda, samples_per_pixel=2)
    n = cfg.n_rays
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    cfg = dataclasses.replace(cfg, use_pallas=True)

    def trace(sc):
        with torch.no_grad():
            return integrator.trace_lanes(sc, static, cfg, o, d, t, rid,
                                          cfg.seed)

    built = []
    real = si.sphere_table
    with monkeypatch.context() as m:
        m.setattr(si, "sphere_table",
                  lambda sp: built.append(real(sp)) or built[-1])
        first = trace(scene)
    assert len(built) == int(static.n_spheres > 0)
    with monkeypatch.context() as m:
        m.setattr(integrator, "kernel_tables", lambda *a: None)
        ref = trace(scene)
    assert all(torch.equal(a, b) for a, b in zip(first, ref))
    if static.n_triangles:
        scene.triangles.v0[:, 1] += 0.25
    else:
        scene.spheres.radius[1:] *= 1.5
    second = trace(scene)
    fresh = trace(SceneData.from_leaves([le.clone()
                                         for le in scene.leaves()], scene.trees))
    assert all(torch.equal(a, b) for a, b in zip(second, fresh))
    assert not torch.equal(first[0], second[0])


def test_staged_render_chunk_matches_plain(cuda):
    """The staged path on the card through K10 (use_pallas "auto") against
    use_pallas=False, two_spheres 64x36x4 d6, with the sphere budgets of
    tests/test_megakernel.py:66-70."""
    import dataclasses

    from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as si

    scene, static, cfg, cam = _frame("two_spheres", cuda)
    n = cfg.n_rays
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    before = si.LAUNCHES
    rad, seg = integrator.trace_lanes(scene, static, cfg, o, d, t, rid,
                                      cfg.seed)
    assert si.LAUNCHES == before + cfg.max_depth
    plain = dataclasses.replace(cfg, use_pallas=False)
    ref, ref_seg = integrator.trace_lanes(scene, static, plain, o, d, t, rid,
                                          cfg.seed)
    assert si.LAUNCHES == before + cfg.max_depth
    assert abs(int(seg.sum()) - int(ref_seg.sum())) <= max(4, n // 300)
    rel = (rad - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 64)
    assert float((rad - ref).abs().mean()) < 3e-3


def test_replay_bwd_global_ktab_matches_reference(cuda):
    """K2 on a scene of 3,970 spheres on a checker ground, whose d(ktab)
    does not fit one block's shared memory and is reduced by
    warp-aggregated global atomics, against torch autograd of the replay on
    the kernel's own codes with K2's budgets, after holding out at most 1%
    of the lanes: those the float64 replay puts on a checker cell edge."""
    scene, static, cfg, cam = _frame("many_spheres", cuda)
    assert static.n_spheres > 3058
    n = cfg.n_rays
    rad, _, codes = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed,
                                    static=static, emit_paths=True)
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    edge = checks.edge_lanes(scene, static, cfg, o, d, t, rid, codes,
                             [slice(0, n)])
    assert int(edge.sum()) <= max(4, n // 100)
    ktab = replay_bwd.pack_ktab(scene)
    args = (ktab, None, scene.background, cfg, o, d, t, rid, cfg.seed, codes,
            2.0 * rad * (~edge).float()[:, None])
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    assert replay_bwd.shared_reductions(_build.load_library(), cuda,
                                        ktab.shape[1], 0) == (False, False)
    got = replay_bwd.replay_bwd_fused(*args, n)
    ref = replay_bwd.replay_bwd_reference(*args)
    for g_, r_ in zip(got, ref):
        if r_ is not None:
            _agree(g_, r_)
    assert int((got[0].abs().sum(0) > 0).sum()) > 100   # spheres reached


@pytest.mark.parametrize("name", ["jumpy_balls", "wavefront_cow_obj",
                                  "earth", "two_perlin_spheres",
                                  "simple_light"])
def test_replay_bwd_global_ktab_equals_shared(cuda, monkeypatch, name):
    """The same launch with d(ktab) (and d(ptab)) forced to global atomics
    gives the shared-memory reduction's cotangents but for the order of
    float additions, for every family of instantiations a scene that fits
    can reach: spheres (K2), spheres and a mesh (K4), deferred image (K7)
    and noise (K7 with cabc) textures, spheres and rects deferred."""
    from raytracer_weekend_tpu_torch import fused_diff
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    scene, static, cfg, cam = _frame(name, cuda)
    n = cfg.n_rays
    rad, _, codes, *recs = mk.render_fused(
        scene, cfg, cam, 0, n, cfg.seed, static=static, emit_paths=True,
        emit_deferred=mk.defers(static))
    g, cabc = 2.0 * rad, None
    if recs:
        g, cabc, _ = fused_diff.combine_vjp(scene, static, recs, g, [])
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    ptab = (replay_bwd.pack_ptab(scene, static)
            if static.n_rects + static.n_triangles else None)
    args = (replay_bwd.pack_ktab(scene), ptab, scene.background, cfg, o, d,
            t, rid, cfg.seed, codes, g, n)
    lib = _build.load_library()
    assert replay_bwd.shared_reductions(lib, cuda, static.n_spheres, 0)[0]
    shared = replay_bwd.replay_bwd_fused(*args, cabc=cabc)
    monkeypatch.setattr(replay_bwd, "shared_reductions",
                        lambda *a: (False, False))
    glob = replay_bwd.replay_bwd_fused(*args, cabc=cabc)
    # earth's d(ktab) is 0: its only sphere's texels belong to the combine.
    assert any(float(a.abs().max()) > 0 for a in shared if a is not None)
    for a, b in zip(shared, glob):
        if a is not None:
            assert float((a - b).norm()) <= 1e-5 * float(a.norm()) + 1e-12


def test_render_image_staged_uvdebug_launches_k10(cuda):
    """jumpy_balls with a uv-debug ground is outside `fused_supported`:
    render_image takes the staged path on K10 in ray_batch chunks, and
    gives the plain staged path's image within the sphere budgets."""
    import dataclasses

    from raytracer_weekend_tpu_torch.ops.cuda import sphere_intersect as si

    scene, static, cfg, cam = _frame("jumpy_balls_uvdebug", cuda,
                                     ray_batch=4000)
    assert not mk.fused_supported(static, cfg)
    before = mk.LAUNCHES, si.LAUNCHES
    img = integrator.render_image(scene, static, cfg, cam)
    chunks = -(-cfg.n_rays // 4000)
    assert mk.LAUNCHES == before[0]
    assert si.LAUNCHES == before[1] + chunks * cfg.max_depth
    ref = integrator.render_image(scene, static,
                                  dataclasses.replace(cfg, use_pallas=False),
                                  cam)
    assert si.LAUNCHES == before[1] + chunks * cfg.max_depth
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    rel = (img - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=-1).sum()) <= max(4, cfg.n_pixels // 64)


# ---- the staged path through a tree: BVH-tri and BVH-sph ---------------------

def _bvh_rays(name, cuda):
    """(scene, static, cfg, cam, kind, [(what, o, d, time)]): the primary
    and first-bounce rays of a tree scene at 64x36x4, and 2^15 random rays
    from around its tree's root box."""
    import dataclasses

    scene, static, cfg, cam = _frame(name, cuda)
    kind = "spheres" if static.sphere_bvh else "triangles"
    ids = torch.arange(cfg.n_rays, device=cuda)
    o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, cfg.seed)
    *_, (o1, d1, _, _, alive, _) = integrator.trace_lanes(
        scene, static, dataclasses.replace(cfg, max_depth=1, use_pallas=False),
        o, d, t, rid, cfg.seed, return_carry=True)
    tree = scene.sphere_bvh if kind == "spheres" else scene.triangle_bvh
    g = torch.Generator(device="cpu").manual_seed(7)
    lo, hi = tree.bmin[0].cpu(), tree.bmax[0].cpu()
    tgt = lo + (hi - lo) * torch.rand((1 << 15, 3), generator=g)
    ro = tgt + torch.randn((1 << 15, 3), generator=g) * (hi - lo).norm()
    rd = tgt - ro
    rd[:6] = torch.cat([torch.eye(3), -torch.eye(3)])   # zero components
    rt = torch.rand((1 << 15,), generator=g)
    return scene, static, cfg, cam, kind, [
        ("primary", o, d, t), ("first bounce", o1[alive], d1[alive], t[alive]),
        ("random", ro.to(cuda), rd.to(cuda), rt.to(cuda))]


@pytest.mark.parametrize("name", ["wavefront_cow_obj", "book2_final_scene"])
def test_bvh_kernel_matches_plain(cuda, name):
    """BVH-tri (the cow) and BVH-sph (book2) bit for bit the plain traverse
    run on the card (t and prim on every lane), and their Functions' VJP of
    a random cotangent the plain route's on the card: the rays' bit for bit,
    the table's but for the order of the atomic adds of `_rows`'s
    backward (1e-5)."""
    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt

    scene, static, cfg, cam, kind, cases = _bvh_rays(name, cuda)
    tree = scene.sphere_bvh if kind == "spheres" else scene.triangle_bvh
    table = getattr(scene, kind)
    tabs = bt.tables(kind, tree, table)
    walk = bt.traverse_spheres if kind == "spheres" else \
        bt.traverse_triangles
    for what, o, d, t in cases:
        rays = (o, d, t) if kind == "spheres" else (o, d)
        before = bt.SPHERE_LAUNCHES + bt.TRIANGLE_LAUNCHES
        t_k, p_k = walk(tree, table, *rays, cfg.t_min, tables=tabs)
        assert bt.SPHERE_LAUNCHES + bt.TRIANGLE_LAUNCHES == before + 1
        t_p, p_p = walk(tree, table, *rays, cfg.t_min, plain=True)
        assert bt.SPHERE_LAUNCHES + bt.TRIANGLE_LAUNCHES == before + 1
        assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p), what
        assert int(torch.isfinite(t_k).sum()) > o.shape[0] // 20, what
    o, d, t = cases[0][1:]
    ct = torch.randn(o.shape[0], device=cuda)
    grads = []
    for plain in (False, True):
        fields = [f.detach().clone().requires_grad_()
                  if f.is_floating_point() else f for f in table]
        rays = [x.detach().clone().requires_grad_()
                for x in ((o, d, t) if kind == "spheres" else (o, d))]
        tk, _ = walk(tree, type(table)(*fields), *rays, cfg.t_min,
                     plain=plain)
        wrt = [f for f in fields if f.requires_grad] + rays
        grads.append(torch.autograd.grad(tk, wrt, ct, allow_unused=True))
    n_rays = 3 if kind == "spheres" else 2
    for i, (a, b) in enumerate(zip(*grads)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if i >= len(grads[0]) - n_rays:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-6 * float(b.abs().max()))


def test_bvh_kernel_nan_slab_misses(cuda):
    """A ray with d.x = 0 on the root box's x plane: 0 * inf = NaN misses the
    box in the kernel as in the plain traverse (fminf would drop it)."""
    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt

    from raytracer_weekend_tpu_torch.scene import builder

    mat = builder.Lambertian((1, 1, 1))
    scene, _ = build_scene([
        builder.Triangle.flat_shaded(((0, 0, 0), (1, 0, 0), (0, 1, 0)), mat),
        builder.Triangle.flat_shaded(((3, 0, 0), (4, 0, 0), (3, 1, 0)), mat)],
        bvh=True)
    scene = scene.to(cuda)
    x0 = float(scene.triangle_bvh.bmin[0, 0])
    o = torch.tensor([[x0, 0.2, -1.0], [0.1, 0.2, -1.0]], device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], device=cuda)
    t, prim = bt.traverse_triangles(scene.triangle_bvh, scene.triangles, o,
                                    d, 1e-3)
    tp, pp = bt.traverse_triangles(scene.triangle_bvh, scene.triangles, o,
                                   d, 1e-3, plain=True)
    assert torch.equal(t, tp) and torch.equal(prim, pp)
    assert float(t[0]) == float("inf") and float(t[1]) == 1.0


def test_staged_render_with_tree_launches_bvh(cuda):
    """The cow's staged path under "auto" walks its tree with BVH-tri (once
    a bounce) and gives use_pallas=False's image (the plain traverse, the
    plain brute force for its sphere and rect) within the planar budgets."""
    import dataclasses

    from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse as bt
    from raytracer_weekend_tpu_torch.ops.cuda import triangle_intersect as ti

    scene, static, cfg, cam = _frame("wavefront_cow_obj", cuda)
    assert static.triangle_bvh
    assert integrator.hit_routes(scene, static, cfg, cuda)["triangles"] == (
        "bvh")
    n = cfg.n_rays
    o, d, t, rid = integrator._pixel_rays(
        cam, cfg, torch.arange(n, device=cuda), cfg.seed)
    before = bt.TRIANGLE_LAUNCHES, ti.LAUNCHES
    rad, seg = integrator.trace_lanes(scene, static, cfg, o, d, t, rid,
                                      cfg.seed)
    assert bt.TRIANGLE_LAUNCHES == before[0] + cfg.max_depth
    assert ti.LAUNCHES == before[1]
    plain = dataclasses.replace(cfg, use_pallas=False)
    ref, ref_seg = integrator.trace_lanes(scene, static, plain, o, d, t, rid,
                                          cfg.seed)
    assert abs(int(seg.sum()) - int(ref_seg.sum())) <= max(4, n // 200)
    rel = (rad - ref).abs() / (ref.abs() + 1e-3)
    assert int((rel > 0.05).any(dim=1).sum()) <= max(4, n // 100)
    assert float((rad - ref).abs().mean()) < 1e-3


_MESH_RANK = r"""
import os, sys
import torch
rank, size, store, width, height = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], int(sys.argv[4]),
                                    int(sys.argv[5]))
os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(size)
from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models.scenes import generate_scene
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.parallel import mesh, shard
assert mesh.distributed_init(init_method=f"file://{store}", rank=rank,
                             world_size=size, timeout_s=120) == "gloo"
rmesh = mesh.make_render_mesh((size, 1, 1))
assert rmesh.device == torch.device("cuda", 0)
cfg = RenderConfig(width=width, height=height, samples_per_pixel=4,
                   max_depth=8, seed=3)
scene, static, cams = generate_scene("jumpy_balls", cfg.aspect_ratio,
                                     device=rmesh.device)
with torch.no_grad():
    ref = integrator.render_image(scene, static, cfg, cams[0])
    mk.LAUNCHES = 0
    img = shard.render_sharded(scene, static, cfg, cams[0], rmesh)
assert mk.LAUNCHES >= 1, mk.LAUNCHES
assert torch.equal(img, ref)
mesh.dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.mark.parametrize("size,width,height", [(2, 64, 36), (3, 64, 35)])
def test_mesh_rays_shards_bitwise(cuda, tmp_path, size, width, height):
    """A gloo world of `size` ranks sharing the card renders jumpy_balls
    through render_sharded on (size, 1, 1): every rank launches K1 on its
    pixel block and gets the single-device render_image bit for bit. At
    64x35 on 3 ranks the last block runs past the frame (2,240 pixels in
    blocks of 747) and is trimmed."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, str(r), str(size), str(store),
         str(width), str(height)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(size)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log.decode(errors="replace"))
    for r, log in enumerate(logs):
        assert f"RANK_OK {r}" in log, log[-3000:]


# ---- the image-only deferred combine pair (csrc/combine.cu) ----------------


def _earth_fit_records(cuda, width=96, height=54, spp=4, depth=50):
    """earth.fit16's scene (rtbench's `earth` configuration: the earth over
    a checker ground, the general combine) at a reduced frame, and its
    K6a-emit records: views of one row buffer."""
    from rtbench import common, port
    from rtbench.reference import scenes as RS

    conf = common.load_json(common.ROOT / "configs" / "earth.json")
    conf.update(width=width, height=height)
    scene, static, cam = port.build(RS.make_scene(conf), cuda)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth, seed=5)
    _, _, _, *recs = mk.render_fused_records(
        scene, cfg, cam, 0, cfg.n_rays, cfg.seed, static=static,
        emit_paths=True)
    return scene, static, cfg, cam, recs


def _torch_combine_grads(tex, ctb, abc, dcode, g):
    """The general combine's torch autograd at the anchored abc (what
    fused_diff.combine_vjp ran for these scenes before the pair) ->
    (g_k, the atlas's gradient)."""
    images = tex.images.detach().clone().requires_grad_()
    c = ctb.detach().clone().requires_grad_()
    rad = mk.combine_deferred(
        tex._replace(images=images), c,
        torch.where((dcode != 0)[..., None], abc, 0.5), dcode,
        has_noise=False, has_image=True)
    return torch.autograd.grad(rad, [c, images], g)


def _rel_l1(got, want):
    return float((got - want).abs().sum() / want.abs().sum())


def test_image_combine_kernels_match_torch(cuda):
    """On earth.fit16's records at 96x54, 4 spp, depth 50: the forward
    kernel's radiance and factor product bitwise the torch loop of
    `combine_deferred` on the card (also from packed records, and chained
    over three spans of bounces with `init`); the VJP kernel's g_k bitwise
    autograd's and the plain version's, its texel gradient within 1e-5
    relative L1 of both (atomics add in another order)."""
    from raytracer_weekend_tpu_torch.ops.cuda import image_combine as ic

    scene, static, cfg, cam, (ctb, abc, dcode) = _earth_fit_records(cuda)
    assert static.has_image and not static.has_noise
    assert not static.defer_single_hit
    tex = scene.textures
    n, D = dcode.shape
    assert ic.record_rows(ctb, abc, dcode).data_ptr() == ctb.data_ptr()
    assert int((dcode != 0).sum()) > n // 20
    want = mk.combine_deferred(tex, ctb, abc, dcode, has_noise=False,
                               has_image=True, return_factors=True)
    before = ic.COMBINE_LAUNCHES, ic.COMBINE_VJP_LAUNCHES
    got = ic.combine_images(tex, ctb, abc, dcode, return_factors=True)
    assert ic.COMBINE_LAUNCHES == before[0] + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    packed = ic.combine_images(tex, *(r.contiguous() for r in (ctb, abc,
                                                              dcode)))
    assert torch.equal(packed, want[0])
    acc = None
    for lo, hi in ((0, 7), (7, 30), (30, D)):
        acc = ic.combine_images(tex, ctb[:, lo:hi], abc[:, lo:hi],
                                dcode[:, lo:hi], init=acc,
                                return_factors=True)
    assert torch.equal(acc[0], want[0]) and torch.equal(acc[1], want[1])
    g = torch.randn((n, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    g_k, d_images = ic.combine_images_vjp(tex, ctb, abc, dcode, g)
    assert ic.COMBINE_VJP_LAUNCHES == before[1] + 1
    want_gk, want_img = _torch_combine_grads(tex, ctb, abc, dcode, g)
    plain_gk, plain_img = ic.combine_images_vjp_reference(tex, ctb, abc,
                                                          dcode, g)
    assert torch.equal(g_k, want_gk) and torch.equal(g_k, plain_gk)
    assert _rel_l1(d_images, want_img) < 1e-5
    assert _rel_l1(d_images, plain_img) < 1e-5
    g_k2, none = ic.combine_images_vjp(tex, ctb, abc, dcode, g,
                                       texel_grad=False)
    assert none is None and torch.equal(g_k2, g_k)


def test_image_combine_kernels_edge_cases(cuda):
    """The synthetic records of tests/image_records.py on the card (an atlas
    of two images, texels 0 in a channel, lanes of 3+ live records,
    all-dead lanes, zero records past a lane's end, UVs at the poles and
    outside [0, 1], sphere and planar texels): the kernels against the
    plain versions, rad, F and g_k bitwise, the texel gradient within 1e-5
    relative L1."""
    from raytracer_weekend_tpu_torch.ops.cuda import image_combine as ic

    from image_records import synthetic

    scene, _, ctb, abc, dcode = synthetic(cuda)
    tex = scene.textures
    want = ic.combine_images_reference(tex, ctb, abc, dcode,
                                       return_factors=True)
    got = ic.combine_images(tex, ctb, abc, dcode, return_factors=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g = torch.randn((dcode.shape[0], 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    g_k, d_images = ic.combine_images_vjp(tex, ctb, abc, dcode, g)
    plain_gk, plain_img = ic.combine_images_vjp_reference(tex, ctb, abc,
                                                          dcode, g)
    assert torch.equal(g_k, plain_gk)
    assert _rel_l1(d_images, plain_img) < 1e-5
    assert bool(torch.isfinite(d_images).all())


def test_fit_step_takes_image_combine(cuda):
    """FitRun.step on earth.fit16's scene at a reduced frame goes through
    the pair: one forward and one VJP launch a step; traced, its
    `combine_kernel_slots` equal `record_slots`. A deep render of the same
    scene chains its phases through the forward kernel, bitwise the single
    pass."""
    from raytracer_weekend_tpu_torch import train
    from raytracer_weekend_tpu_torch.ops.cuda import image_combine as ic
    from raytracer_weekend_tpu_torch.utils import metrics

    scene, static, cfg, cam, _ = _earth_fit_records(cuda, 64, 36, 2, 50)
    target = torch.full((cfg.height, cfg.width, 3), 0.4, device=cuda)
    run = train.InverseRenderer(static, cfg, cam, target).start(scene)
    before = ic.COMBINE_LAUNCHES, ic.COMBINE_VJP_LAUNCHES
    metrics.reset_counters()
    try:
        with metrics.tracing():
            run.step()
        counts = metrics.counters()
    finally:
        metrics.reset_counters()
    assert (ic.COMBINE_LAUNCHES, ic.COMBINE_VJP_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert counts["combine_kernel_slots"] == counts["record_slots"] == (
        cfg.n_rays * cfg.max_depth)
    assert bool(torch.isfinite(run.scene.textures.images).all())
    n = cfg.n_rays
    launches = ic.COMBINE_LAUNCHES
    deep = mk.render_fused_deep(scene, cfg, cam, 0, n, cfg.seed,
                                static=static)
    assert ic.COMBINE_LAUNCHES > launches + 1       # one a phase
    single = mk.render_fused(scene, cfg, cam, 0, n, cfg.seed, static=static,
                             deep=False)
    assert all(torch.equal(a, b) for a, b in zip(deep, single))


def test_noise_scenes_keep_torch_combine(cuda):
    """Scenes with noise records keep the torch combine and its autograd:
    book2's depth-phased frame and two_perlin_spheres' forward+backward
    launch neither kernel of the pair."""
    from raytracer_weekend_tpu_torch.fused_diff import render_fused_diff
    from raytracer_weekend_tpu_torch.ops.cuda import image_combine as ic

    before = ic.COMBINE_LAUNCHES, ic.COMBINE_VJP_LAUNCHES
    scene, static, cfg, cam = _frame("book2_final_scene", cuda, width=40,
                                     height=22, max_depth=20)
    assert static.has_noise and static.has_image
    integrator.render_image(scene, static, cfg, cam)
    scene, static, cfg, cam = _frame("two_perlin_spheres", cuda, width=32,
                                     height=18)
    pg = scene.textures.perlin_grad.clone().requires_grad_()
    scene = scene._replace(textures=scene.textures._replace(perlin_grad=pg))
    rad = render_fused_diff(scene, static, cfg, cam, 0, cfg.n_rays, cfg.seed)
    torch.autograd.grad(rad.sum(), pg)
    assert (ic.COMBINE_LAUNCHES, ic.COMBINE_VJP_LAUNCHES) == before
