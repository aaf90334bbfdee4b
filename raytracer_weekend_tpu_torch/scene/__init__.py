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
    Cuboid,
    Dielectric,
    DiffuseLight,
    Lambertian,
    Metal,
    MovingSphere,
    SolidColor,
    Sphere,
    Triangle,
    UVDebug,
    XYRectangle,
    XZRectangle,
    YZRectangle,
    build_scene,
)

__all__ = [
    "SceneData", "SceneStatic", "Spheres", "Rects", "Triangles", "Volumes",
    "build_scene", "Sphere", "MovingSphere", "XYRectangle", "XZRectangle",
    "YZRectangle", "Cuboid", "Triangle",
    "Lambertian", "Metal", "Dielectric", "DiffuseLight",
    "SolidColor", "Checker", "UVDebug",
]
