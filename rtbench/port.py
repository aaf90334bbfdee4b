"""The program's side of an input: a `SceneDesc` through the program's own
scene builder and camera, onto the device.

This is the only module of the benchmark, with the drivers, that imports
the program (`raytracer_weekend_tpu_torch`); the reference never does.
"""

from __future__ import annotations

from rtbench.reference.scenes import SceneDesc


def build(desc: SceneDesc, device):
    """-> (SceneData on `device`, SceneStatic, Camera on `device`)."""
    from raytracer_weekend_tpu_torch.camera import make_camera
    from raytracer_weekend_tpu_torch.scene import builder as B

    tex = []
    for t in desc.textures:
        kind = t["type"]
        if kind == "solid":
            tex.append(B.SolidColor(t["color1"]))
        elif kind == "checker":
            tex.append(B.Checker(B.SolidColor(t["color1"]),
                                 B.SolidColor(t["color2"]), t["scale"]))
        elif kind == "noise":
            tex.append(B.NoiseTexture(t["scale"]))
        elif kind == "image":
            tex.append(B.ImageTexture(data=desc.images[t["image"]]))
        else:
            raise ValueError(f"texture {kind!r}")
    mats = []
    for m in desc.materials:
        kind = m["type"]
        if kind == "lambertian":
            mats.append(B.Lambertian(tex[m["tex"]]))
        elif kind == "metal":
            mats.append(B.Metal(tex[m["tex"]], m["fuzz"]))
        elif kind == "dielectric":       # the builder adds its white texture
            mats.append(B.Dielectric(m["ior"]))
        elif kind == "light":
            mats.append(B.DiffuseLight(tex[m["tex"]]))
        elif kind == "isotropic":        # a medium's; the builder makes it
            mats.append(None)
        else:
            raise ValueError(f"material {kind!r}")
    objs = []
    for c0, c1, t0, t1, r, m in desc.spheres:
        if c0 == c1 and (t0, t1) == (0.0, 1.0):
            objs.append(B.Sphere(c0, r, mats[m]))
        else:
            objs.append(B.MovingSphere(c0, t0, c1, t1, r, mats[m]))
    for axis, a0, a1, b0, b1, k, m in desc.rects:
        objs.append(B._Rect(axis, a0, a1, b0, b1, k, mats[m]))
    for verts, norms, uvs, m in desc.triangles:
        objs.append(B.Triangle(verts, mats[m], normals=norms, uvs=uvs))
    for center, radius, density, m in desc.volumes:
        boundary = B.Sphere(center, radius, B.Dielectric(1.5))
        objs.append(B.ConstantMedium(boundary, density,
                                     tex[desc.materials[m]["tex"]]))
    data, static = B.build_scene(objs, background=desc.background,
                                 seed=desc.perlin_seed)
    c = desc.camera
    cam = make_camera(c["look_from"], c["look_at"], c["up"], c["vfov"],
                      c["aspect"], c["aperture"], c["focus"], c["t0"],
                      c["t1"])
    return data.to(device), static, cam.to(device)
