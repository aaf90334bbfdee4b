"""The catalog's scenes (port of `models/scenes.py`).

Each generator returns (objects, cameras, background), with the same
geometry, materials, camera parameters and seeded numpy draws as the JAX
package's, so both builders compile them to bit-equal tables. The
earthmap's texels come from `assets/earthmap.npz`, the JPEG of `models/`
decoded once with Pillow, so a machine without Pillow renders the same
texels.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from raytracer_weekend_tpu_torch.camera import Camera, make_camera
from raytracer_weekend_tpu_torch.scene import builder as B
from raytracer_weekend_tpu_torch.scene.objloader import load_wavefront_obj

DEFAULT_BACKGROUND = (0.7, 0.8, 1.0)
_DIM_SKY = (0.085, 0.1, 0.125)

# Model assets live in the repository's models/ directory.
_MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "models")
_EARTHMAP = os.path.join(os.path.dirname(__file__), "..", "assets",
                         "earthmap.npz")


def model_path(name: str) -> str:
    p = os.path.join(_MODEL_DIR, name)
    if not os.path.exists(p):
        raise FileNotFoundError(f"model asset {name} not found in "
                                f"{os.path.normpath(_MODEL_DIR)}")
    return p


def earthmap() -> np.ndarray:
    """models/earthmap.jpg as Pillow decodes it, (512, 1024, 3) float32 in
    [0, 1]: the package's uint8 copy / 255, bit for bit the JAX builder's
    `ImageTexture(path)` texels."""
    with np.load(_EARTHMAP) as z:
        return z["earthmap"].astype(np.float32) / 255.0


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


def two_perlin_spheres(aspect, seed=0):
    mat = B.Lambertian(B.NoiseTexture(4.0))
    objs = [
        B.Sphere((0, -1000, 0), 1000.0, mat),
        B.Sphere((0, 2, 0), 2.0, mat),
    ]
    return objs, [_cam((13, 2, 3), (0, 0, 0), 40.0, aspect)], DEFAULT_BACKGROUND


def earth(aspect, seed=0):
    tex = B.ImageTexture(data=earthmap())
    objs = [B.Sphere((0, 0, 0), 2.0, B.Lambertian(tex))]
    return objs, [_cam((13, 2, 3), (0, 0, 0), 20.0, aspect)], DEFAULT_BACKGROUND


def simple_light(aspect, seed=0):
    """A noise ground and sphere lit by an earthmap-textured rect and sphere
    light (image-texture emission), on a black background."""
    emissive = B.DiffuseLight(B.ImageTexture(data=earthmap()))
    ground = B.Lambertian(B.NoiseTexture(4.0))
    objs = [
        B.Sphere((0, -1000, 0), 1000.0, ground),
        B.Sphere((0, 2, 0), 2.0, ground),
        B.XYRectangle(3.0, 5.0, 1.0, 3.0, -2.0, emissive),
        B.Sphere((0, 6, 0), 2.0, emissive),
    ]
    return objs, [_cam((26, 3, 6), (0, 2, 0), 20.0, aspect)], (0.0, 0.0, 0.0)


def _cornell_walls(light_rect):
    """The Cornell room's five walls and its light -> (white, objects)."""
    red = B.Lambertian((0.65, 0.05, 0.05))
    white = B.Lambertian((0.73, 0.73, 0.73))
    green = B.Lambertian((0.12, 0.45, 0.15))
    return white, [
        B.YZRectangle(0.0, 555.0, 0.0, 555.0, 555.0, green),
        B.YZRectangle(0.0, 555.0, 0.0, 555.0, 0.0, red),
        light_rect,
        B.XZRectangle(0.0, 555.0, 0.0, 555.0, 0.0, white),
        B.XZRectangle(0.0, 555.0, 0.0, 555.0, 555.0, white),
        B.XYRectangle(0.0, 555.0, 0.0, 555.0, 555.0, white),
    ]


def cornell_box(aspect, seed=0):
    """Rect walls, a ceiling light, two rotated cuboids (as triangles)."""
    light = B.DiffuseLight((15.0, 15.0, 15.0))
    white, objs = _cornell_walls(
        B.XZRectangle(213.0, 343.0, 227.0, 332.0, 554.0, light))
    objs += [
        B.Cuboid((0, 0, 0), (165, 330, 165), white)
         .rotate_y(15.0).translate((265, 0, 295)),
        B.Cuboid((0, 0, 0), (165, 165, 165), white)
         .rotate_y(-18.0).translate((130, 0, 65)),
    ]
    cam = _cam((278, 278, -800), (278, 278, 0), 40.0, aspect)
    return objs, [cam], (0.0, 0.0, 0.0)


def smokey_cornell_box(aspect, seed=0):
    """The Cornell room with its two cuboids as constant-density smoke."""
    light = B.DiffuseLight((7.0, 7.0, 7.0))
    white, objs = _cornell_walls(
        B.XZRectangle(113.0, 443.0, 127.0, 432.0, 554.0, light))
    box1 = (B.Cuboid((0, 0, 0), (165, 330, 165), white)
            .rotate_y(15.0).translate((265, 0, 295)))
    box2 = (B.Cuboid((0, 0, 0), (165, 165, 165), white)
            .rotate_y(-18.0).translate((130, 0, 65)))
    objs += [
        B.ConstantMedium(box1, 0.005, B.SolidColor((0.0, 0.0, 0.0))),
        B.ConstantMedium(box2, 0.005, B.SolidColor((1.0, 1.0, 1.0))),
    ]
    cam = _cam((278, 278, -800), (278, 278, 0), 40.0, aspect)
    return objs, [cam], (0.0, 0.0, 0.0)


def book2_final_scene(aspect, seed=0):
    """The Next Week's final scene: 400 ground cuboids of random heights, a
    light, moving, glass, metal, earth and marble spheres, a medium inside a
    glass sphere, a mist over everything and a rotated cluster of 1000
    spheres; 1,006 spheres, 2,401 rects, 2 media."""
    rng = np.random.default_rng(seed + 2)
    ground = B.Lambertian((0.48, 0.83, 0.53))
    objs = []
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = rng.uniform(1.0, 101.0)
            objs.append(B.Cuboid((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground))

    objs.append(B.XZRectangle(123.0, 423.0, 147.0, 412.0, 554.0,
                              B.DiffuseLight((7.0, 7.0, 7.0))))
    objs.append(B.MovingSphere((400, 400, 200), 0.0, (430, 400, 200), 1.0,
                               50.0, B.Lambertian((0.7, 0.3, 0.1))))
    objs.append(B.Sphere((260, 150, 45), 50.0, B.Dielectric(1.5)))
    objs.append(B.Sphere((0, 150, 145), 50.0, B.Metal((0.8, 0.8, 0.9), 1.0)))

    boundary = B.Sphere((360, 150, 145), 70.0, B.Dielectric(1.5))
    objs.append(boundary)
    objs.append(B.ConstantMedium(boundary, 0.2, B.SolidColor((0.2, 0.4, 0.9))))
    mist = B.Sphere((0, 0, 0), 5000.0, B.Dielectric(1.5))
    objs.append(B.ConstantMedium(mist, 0.0001, B.SolidColor((1.0, 1.0, 1.0))))

    objs.append(B.Sphere((400, 200, 400), 100.0,
                         B.Lambertian(B.ImageTexture(data=earthmap()))))
    objs.append(B.Sphere((220, 280, 300), 80.0,
                         B.Lambertian(B.NoiseTexture(0.1))))

    white = B.Lambertian((0.73, 0.73, 0.73))
    for _ in range(1000):
        c = rng.uniform(0.0, 165.0, 3)
        objs.append(B.Sphere(tuple(c), 10.0, white)
                    .rotate_y(15.0).translate((-100, 270, 395)))

    look_from = (478, 278, -600)
    look_at = (278, 278, 0)
    focus = float(np.linalg.norm(np.subtract(look_at, look_from)))
    cam = _cam(look_from, look_at, 40.0, aspect, focus=focus)
    return objs, [cam], (0.0, 0.0, 0.0)


def animated_book2_final(aspect, seed=0):
    """book2's world under 30 dolly cameras (aperture 1)."""
    objs, _, bg = book2_final_scene(aspect, seed)
    look_at = np.array([278.0, 278.0, 278.0])
    frames = int(10.0 * 3.0)
    cams = []
    for frame in range(frames):
        from_x = 478.0 - frame * (2.0 * 478.0) / frames
        look_from = np.array([from_x, 278.0, -600.0])
        focus = float(np.linalg.norm(look_at - look_from))
        cams.append(_cam(tuple(look_from), tuple(look_at), 40.0, aspect,
                         aperture=1.0, focus=focus))
    return objs, cams, bg


def simple_triangle(aspect, seed=0):
    """A UV-debug triangle over a checker ground sphere."""
    objs = [
        B.Sphere((0, -10, 0), 10.0, B.Lambertian(_checker())),
        B.Triangle.flat_shaded(((-5, 0, 5), (0, 7, 0), (5, 0, -5)),
                               B.Lambertian(B.UVDebug())),
    ]
    return objs, [_cam((13, 2, 3), (0, 2.5, 0), 40.0, aspect)], DEFAULT_BACKGROUND


def wavefront_cow_obj(aspect, seed=0):
    """cow-nonormals.obj (5,804 triangles, face normals, no usemtl: the
    magenta light fallback) + an area light + a checker ground."""
    cow = load_wavefront_obj(model_path("cow-nonormals.obj"))
    cow = [t.translate((0.0, 2.5, 0.0)) for t in cow]
    objs = [
        B.Sphere((0, -10.6, 0), 10.0, B.Lambertian(_checker())),
        B.XYRectangle(1.0, 5.0, 1.0, 7.0, 5.0,
                      B.DiffuseLight((1.4, 1.3, 1.3))),
        cow,
    ]
    return objs, [_cam((13, 2, 3), (0, 2.5, 0), 40.0, aspect)], _DIM_SKY


def wavefront_suspension_obj(aspect, seed=0):
    """Normals_Try3.obj (vertex normals) + an area light."""
    susp = load_wavefront_obj(model_path("Normals_Try3.obj"))
    susp = [t.translate((0.0, 2.5, 0.0)) for t in susp]
    objs = [
        B.XYRectangle(-5.0, 5.0, -7.0, 7.0, 1.0,
                      B.DiffuseLight((1.2, 1.0, 1.0))),
        susp,
    ]
    cam = _cam((0.5, 2.5, 0.8), (-0.1, 2.3, 0.15), 40.0, aspect)
    return objs, [cam], _DIM_SKY


def textured_monument(aspect, seed=0):
    """The monument OBJ + MTL under an area light. Its diffuse PNG is absent
    from the repository (as from the reference's checkout), so the loader
    substitutes a neutral gray, as the JAX package's scene does."""
    monument = load_wavefront_obj(
        model_path("monument_downscaled_polygon_reduced.obj"),
        missing_texture_fallback=(0.6, 0.6, 0.6))
    monument = [t.translate((0.0, 0.0, -19.0)) for t in monument]
    objs = [
        B.XYRectangle(-15.0, 15.0, -17.0, 17.0, 33.0,
                      B.DiffuseLight((1.2, 1.0, 1.0))),
        monument,
    ]
    cam = _cam((-5, -30, 25), (0, 0, 5), 40.0, aspect, up=(1, 0, 0))
    return objs, [cam], _DIM_SKY


def mesh_shards(aspect, seed=0):
    """Not a catalog scene: the smooth-normal mesh of the JAX package's
    tests (tests/test_megakernel.py, `mesh_scene`), 40 random triangles with
    random vertex normals between a floor rect and a light rect. The kernel
    tests use it for the interpolated shading normal."""
    rng = np.random.default_rng(42)
    objs = [B.XZRectangle(-6, 6, -6, 6, -1.2, B.Lambertian((0.6, 0.6, 0.6))),
            B.XZRectangle(-2, 2, -2, 2, 4.0, B.DiffuseLight((4, 4, 4)))]
    mats = [B.Lambertian((0.8, 0.3, 0.3)), B.Metal((0.9, 0.9, 0.9), 0.05)]
    for i in range(40):
        v = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
        n = rng.normal(size=(3, 3)).astype(np.float32) * 1.5
        objs.append(B.Triangle(
            tuple(tuple(float(c) for c in x) for x in v), mats[i % 2],
            normals=tuple(tuple(float(c) for c in x) for x in n)))
    cam = make_camera(look_from=(0, 1, -8), look_at=(0, 0, 0),
                      up_vector=(0, 1, 0), vertical_field_of_view=45.0,
                      aspect_ratio=aspect, aperture=0.0, focus_dist=8.0,
                      time0=0.0, time1=1.0)
    return objs, [cam], (0.05, 0.05, 0.08)


def sphere_medium(aspect, seed=0):
    """Not a catalog scene: the sphere-boundary medium (book2's subsurface
    ball) between a floor, a light and a red sphere, the scene of the JAX
    package's tests/test_megakernel.py:228-258. The kernel tests use it for
    a medium with a sphere boundary."""
    objs = [
        B.XZRectangle(-6, 6, -6, 6, -1.5, B.Lambertian((0.5, 0.5, 0.5))),
        B.XZRectangle(-2, 2, -2, 2, 5.0, B.DiffuseLight((5, 5, 5))),
        B.ConstantMedium(B.Sphere((0.0, 0.0, 0.0), 1.2,
                                  B.Lambertian((1, 1, 1))),
                         density=0.6, texture=B.SolidColor((0.2, 0.4, 0.9))),
        B.Sphere((2.5, 0.0, 0.5), 0.8, B.Lambertian((0.8, 0.2, 0.2))),
    ]
    cam = make_camera(look_from=(0, 1, -7), look_at=(0, 0, 0),
                      up_vector=(0, 1, 0), vertical_field_of_view=40.0,
                      aspect_ratio=aspect, aperture=0.0, focus_dist=7.0,
                      time0=0.0, time1=1.0)
    return objs, [cam], (0.02, 0.02, 0.03)


def jumpy_balls_uvdebug(aspect, seed=0):
    """Not a catalog scene: jumpy_balls with a uv-debug ground. The fused
    megakernel takes uv-debug textures on planar primitives only, so this
    scene renders and fits on a card through the staged path, its closest
    hits on kernel K10."""
    objs, cams, bg = jumpy_balls(aspect, seed)
    objs[0] = dataclasses.replace(objs[0],
                                  material=B.Lambertian(B.UVDebug()))
    return objs, cams, bg


def smokey_checker_medium(aspect, seed=0):
    """Not a catalog scene: smokey_cornell_box with the second medium's
    albedo a checker. The fused megakernel takes media with solid albedos
    only, so this scene renders on a card through the staged path: kernel
    K11 for the walls, the plain medium test for the smoke."""
    objs, cams, bg = smokey_cornell_box(aspect, seed)
    objs[-1] = dataclasses.replace(objs[-1], texture=_checker())
    return objs, cams, bg


def many_spheres(aspect, seed=0):
    """Not a catalog scene: 3,969 small spheres on a 63 x 63 grid over the
    ground sphere, about 4,000 in all: more than the 3,058 whose d(ktab)
    fits one block's shared memory in the replay backward (K2), which then
    reduces it by global atomics. The ground is jumpy_balls' checker, the
    small spheres' materials are drawn as jumpy_balls' (Lambertian, metal,
    glass) in solid colors."""
    rng = np.random.default_rng(seed)
    objs = [B.Sphere((0, -1000, 0), 1000.0, B.Lambertian(_checker()))]
    for a in np.linspace(-9.0, 9.0, 63):
        for b in np.linspace(-9.0, 9.0, 63):
            center = (float(a + 0.1 * rng.random()), 0.12,
                      float(b + 0.1 * rng.random()))
            choose = rng.random()
            if choose < 0.75:
                mat = B.Lambertian(tuple(rng.random(3) * rng.random(3)))
            elif choose < 0.92:
                mat = B.Metal(tuple(rng.uniform(0.5, 1.0, 3)),
                              rng.uniform(0.0, 0.5))
            else:
                mat = B.Dielectric(1.5)
            objs.append(B.Sphere(center, 0.12, mat))
    return objs, [_cam((13, 2, 3), (0, 0, 0), 20.0, aspect)], \
        DEFAULT_BACKGROUND


SCENES = {
    "jumpy_balls": jumpy_balls,
    "two_spheres": two_spheres,
    "two_perlin_spheres": two_perlin_spheres,
    "earth": earth,
    "simple_light": simple_light,
    "cornell_box": cornell_box,
    "smokey_cornell_box": smokey_cornell_box,
    "book2_final_scene": book2_final_scene,
    "animated_book2_final_scene": animated_book2_final,
    "simple_triangle": simple_triangle,
    "wavefront_cow_obj": wavefront_cow_obj,
    "wavefront_suspension_obj": wavefront_suspension_obj,
    "textured_monument": textured_monument,
}


def generate_scene(name: str, aspect_ratio: float, seed: int = 0,
                   device="cuda"):
    """Build a named scene -> (scene_data, scene_static, cameras) on `device`.

    The default is the card: with no CUDA device this raises, and it never
    builds on the CPU unless the caller asks with `device="cpu"`.
    """
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; options: {sorted(SCENES)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"generate_scene({name!r}) on {device}: torch sees "
                           f"no CUDA device; pass device='cpu' for the CPU")
    objs, cams, background = SCENES[name](aspect_ratio, seed)
    data, static = B.build_scene(objs, background=background, seed=seed)
    return data.to(device), static, [c.to(device) for c in cams]
