"""The sphere scenes of the catalog (port of `models/scenes.py`).

Each generator returns (objects, cameras, background), with the same
geometry, materials, camera parameters and seeded numpy draws as the JAX
package's, so both builders compile them to bit-equal tables.
"""

from __future__ import annotations

import numpy as np

from raytracer_weekend_tpu_torch.camera import Camera, make_camera
from raytracer_weekend_tpu_torch.scene import builder as B

DEFAULT_BACKGROUND = (0.7, 0.8, 1.0)


def _cam(look_from, look_at, vfov, aspect, aperture=0.0, focus=10.0,
         t0=0.0, t1=1.0, up=(0, 1, 0)) -> Camera:
    return make_camera(look_from, look_at, up, vfov, aspect, aperture, focus,
                       t0, t1)


def _checker():
    return B.Checker(B.SolidColor((0.2, 0.3, 0.1)),
                     B.SolidColor((0.9, 0.9, 0.9)), 10.0)


def jumpy_balls(aspect, seed=0):
    """Book-1 final scene variant with ~480 moving spheres."""
    rng = np.random.default_rng(seed)
    ground = B.Lambertian(_checker())
    glass = B.Dielectric(1.5)
    objs = [
        B.Sphere((0, -1000, 0), 1000.0, ground),
        B.Sphere((-4, 0.2, 0.1), 1.0, B.Lambertian((0.4, 0.2, 0.1))),
        B.Sphere((0, 1, 0), 1.0, glass),
        B.Sphere((0, 1, 0), -0.95, glass),       # hollow shell
        B.Sphere((4, 1, 0), 1.0, B.Metal((0.7, 0.6, 0.5), 0.0)),
    ]
    for a in range(-11, 11):
        for b in range(-11, 11):
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            choose = rng.random()
            if choose < 0.8:
                albedo = tuple(rng.random(3) * rng.random(3))
                mat = B.Lambertian(albedo)
            elif choose < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                mat = B.Metal(albedo, rng.uniform(0.0, 0.5))
            else:
                mat = B.Dielectric(1.5)
            center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
            objs.append(B.MovingSphere(tuple(center), 0.0, tuple(center2), 1.0,
                                       0.2, mat))
    cam = _cam((13, 2, 3), (0, 0, 0), 20.0, aspect, aperture=0.1)
    return objs, [cam], DEFAULT_BACKGROUND


def two_spheres(aspect, seed=0):
    ground = B.Lambertian(_checker())
    objs = [
        B.Sphere((0, -10, 0), 10.0, ground),
        B.Sphere((0, 10, 0), 10.0, ground),
    ]
    return objs, [_cam((13, 2, 3), (0, 0, 0), 40.0, aspect)], DEFAULT_BACKGROUND


SCENES = {
    "jumpy_balls": jumpy_balls,
    "two_spheres": two_spheres,
}


def generate_scene(name: str, aspect_ratio: float, seed: int = 0):
    """Build a named scene -> (scene_data, scene_static, cameras), on the CPU."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; options: {sorted(SCENES)}")
    objs, cams, background = SCENES[name](aspect_ratio, seed)
    data, static = B.build_scene(objs, background=background, seed=seed)
    return data, static, cams
