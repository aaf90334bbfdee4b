"""The CUDA megakernel against its plain torch version, on a card.

Marked `gpu`: each test skips where torch sees no CUDA device, so on a
CPU-only host they count as skipped. Run them where there is a card with

    python -m pytest tests/test_torch_cuda.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from raytracer_weekend_tpu_torch import integrator, rng
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models.scenes import generate_scene
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

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
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=4, max_depth=6)
    scene, static, cams = generate_scene("two_spheres", cfg.aspect_ratio)
    static = type(static)(**{**static.__dict__, "n_rects": 1})
    with pytest.raises(NotImplementedError):
        integrator.render_image(scene.to(cuda), static, cfg, cams[0].to(cuda))
    with pytest.raises(NotImplementedError):
        mk.render_fused(scene.to(cuda), cfg, cams[0].to(cuda), 0, 64, 0,
                        static=static)
