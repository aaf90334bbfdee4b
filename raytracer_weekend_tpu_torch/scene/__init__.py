from raytracer_weekend_tpu_torch.scene.data import (
    Rects,
    SceneData,
    SceneStatic,
    Spheres,
    Triangles,
    Volumes,
)
from raytracer_weekend_tpu_torch.scene.builder import (
    Checker,
    Dielectric,
    DiffuseLight,
    Lambertian,
    Metal,
    MovingSphere,
    SolidColor,
    Sphere,
    build_scene,
)

__all__ = [
    "SceneData", "SceneStatic", "Spheres", "Rects", "Triangles", "Volumes",
    "build_scene", "Sphere", "MovingSphere",
    "Lambertian", "Metal", "Dielectric", "DiffuseLight",
    "SolidColor", "Checker",
]
