"""The port's plain render of every catalog scene against the JAX goldens.

tests/golden/catalog_*.npy pin tiny JAX renders of the 13 catalog scenes
(tests/test_golden.py: `_catalog_case`, the config, and `test_golden_catalog`).
Here each scene is built by the port's own scene functions and builder at
the same config and rendered through the port's `integrator.render_image`
on the CPU (the plain staged path), then compared with the array. The
goldens are read, never written.

The budget is stated per image from readings. The JAX package's own
renders of these scenes move with XLA's compile modes: a lane whose winner
is decided by a last-bit difference (a near-tangent sphere root, a ray
grazing a cuboid edge, a far noise hit on the ground) can take the other
branch and change one sample of one pixel (ROADMAP Queue 3, "XLA's compile
modes flip lanes"). Read on a CPU (the same with 1 and 3 torch threads): 9
of the 13 scenes match their golden within the golden test's own tolerance
(simple_triangle within 4.8e-7, the rest exactly); beyond it, jumpy_balls
has 6 of 336 pixels (max |d| 0.80, a pixel sum of 4 samples up to 4.0),
two_perlin_spheres 10 of 336 (max 1.6e-3), simple_light 1 of 336 (max
4.7e-2) and book2_final_scene 1 of 240 (max 0.88 of sums up to 14). So a
pixel may leave that tolerance (1e-4 absolute + 1e-4 relative) on at most
FLIP_SHARE of the image, and by no more than its scene's reading in
FLIP_MAX with a quarter's headroom; a scene read within the tolerance may
leave it nowhere. Neither bound grows with the port's own output.
"""

import os

import numpy as np
import pytest
import torch

from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models import scenes as tscenes
from raytracer_weekend_tpu_torch.scene import builder as TB

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_golden.py's _BIG: the scenes rendered at the smaller config.
BIG = {"book2_final_scene", "animated_book2_final_scene",
       "wavefront_cow_obj", "wavefront_suspension_obj",
       "textured_monument"}
# Pixels beyond the golden test's tolerance: at most 3% of an image (the
# worst reading, two_perlin_spheres, 10 of 336 = 3.0%, rounded up to a
# whole pixel at 240).
FLIP_SHARE = 0.035
# The largest |d| of such a pixel, read per scene (the scenes not listed
# read none); the bound is FLIP_HEADROOM times it.
FLIP_MAX = {"book2_final_scene": 0.88, "jumpy_balls": 0.80,
            "simple_light": 0.047, "two_perlin_spheres": 1.7e-3}
FLIP_HEADROOM = 1.25
RTOL = ATOL = 1e-4


def _case(name):
    """tests/test_golden.py:_catalog_case through the port."""
    small = name not in BIG
    cfg = RenderConfig(width=24 if small else 20, height=14 if small else 12,
                       samples_per_pixel=4 if small else 2,
                       max_depth=6 if small else 5, seed=11)
    objs, cams, bg = tscenes.SCENES[name](cfg.aspect_ratio)
    scene, static = TB.build_scene(objs, background=bg, seed=cfg.seed)
    return scene, static, cfg, cams[0]


def test_catalog_matches_the_jax_catalog():
    """The 13 catalog scenes, by name: the port's catalog is the JAX one's,
    and each has its golden."""
    from raytracer_weekend_tpu.models.scenes import SCENES as JSCENES

    assert sorted(tscenes.SCENES) == sorted(JSCENES)
    assert len(tscenes.SCENES) == 13
    for name in tscenes.SCENES:
        assert os.path.exists(os.path.join(GOLDEN_DIR,
                                           f"catalog_{name}.npy"))


@pytest.mark.parametrize("name", sorted(tscenes.SCENES))
def test_plain_render_matches_golden(name):
    scene, static, cfg, cam = _case(name)
    with torch.no_grad():
        img = integrator.render_image(scene, static, cfg, cam).numpy()
    golden = np.load(os.path.join(GOLDEN_DIR, f"catalog_{name}.npy"))
    assert img.shape == golden.shape and img.dtype == golden.dtype
    assert np.isfinite(img).all()
    err = np.abs(img.astype(np.float64) - golden)
    off = (err > ATOL + RTOL * np.abs(golden)).any(axis=-1)
    n_pix = off.size
    assert off.sum() <= max(1, int(FLIP_SHARE * n_pix)), (
        name, int(off.sum()), n_pix, float(err.max()))
    worst = float(err.max(axis=-1)[off].max(initial=0.0))
    assert worst <= FLIP_HEADROOM * FLIP_MAX.get(name, 0.0), (name, worst)
