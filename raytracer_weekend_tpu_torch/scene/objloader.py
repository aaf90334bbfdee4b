"""Wavefront OBJ + MTL loading onto the port's builder (port of `scene/objloader.py`).

Produces `builder.Triangle` objects, in numpy only, so meshes compose with
transforms and scene compilation like any other geometry. The rules are the
JAX loader's:

  * polygon faces are fan-triangulated;
  * missing per-vertex normals -> the face normal, missing UVs -> the
    default ((0,0), (1,0), (0,1)), both resolved at scene compile;
  * a face group whose material cannot be resolved gets the magenta
    DiffuseLight debug fallback (also when a `usemtl` name has no loaded
    mtllib);
  * `illum` modes other than ambient-diffuse (0/1) are rejected;
  * point/line records are skipped with a count.

An MTL diffuse map (`map_Kd`) becomes `Lambertian(ImageTexture(path))`,
decoded with Pillow as the JAX loader does; `missing_texture_fallback`
stands in, with a warning, for a map that cannot be read or decoded (the
textured monument's stripped PNG), and without it such a map raises.
"""

from __future__ import annotations

import os
import warnings

from raytracer_weekend_tpu_torch.scene import builder as B


def _resolve_index(idx: int, n: int) -> int:
    """OBJ indices are 1-based; negative counts from the end."""
    return idx - 1 if idx > 0 else n + idx


def _diffuse_map(tex_path: str, missing_texture_fallback):
    try:
        return B.ImageTexture(tex_path)
    except Exception:
        if missing_texture_fallback is None:
            raise
        warnings.warn(f"diffuse map {tex_path!r} unreadable; substituting "
                      f"solid {missing_texture_fallback}")
        return B.SolidColor(tuple(missing_texture_fallback))


def load_wavefront_mtl(path: str, missing_texture_fallback=None):
    """Parse a .mtl file -> {name: Material}."""
    materials: dict[str, object] = {}
    current = None
    props: dict[str, object] = {}

    def finish():
        if current is None:
            return
        illum = props.get("illum", 1)
        if illum not in (0, 1):
            raise ValueError(
                f"material {current!r}: only ambient-diffuse illumination is "
                f"supported (illum {illum})")
        map_kd = props.get("map_Kd")
        if map_kd is not None:
            tex_path = os.path.join(os.path.dirname(path), map_kd)
            materials[current] = B.Lambertian(
                _diffuse_map(tex_path, missing_texture_fallback))
        else:
            materials[current] = B.Lambertian(
                tuple(props.get("Kd", (1.0, 1.0, 1.0))))

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                finish()
                current = parts[1]
                props = {}
            elif key == "illum":
                props["illum"] = int(float(parts[1]))
            elif key == "map_Kd":
                props["map_Kd"] = parts[1]
            elif key == "Kd":
                props["Kd"] = tuple(float(x) for x in parts[1:4])
    finish()
    return materials


def _magenta_light():
    """The debug fallback for unresolvable materials: magenta light."""
    return B.DiffuseLight(B.SolidColor((1.0, 0.0, 1.0)))


def load_wavefront_obj(path: str, missing_texture_fallback=None):
    """Parse an .obj (+.mtl) file -> list[builder.Triangle]."""
    vertices: list = []
    normals: list = []
    texcoords: list = []
    triangles: list = []
    mtl_lib: dict | None = None
    current_material = None      # resolved Material or None
    fallback_material = None     # lazily created magenta light
    skipped = 0

    def material():
        nonlocal fallback_material
        if current_material is not None:
            return current_material
        if fallback_material is None:
            fallback_material = _magenta_light()
        return fallback_material

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vertices.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                texcoords.append(tuple(float(x) for x in parts[1:3]))
            elif key == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), parts[1])
                try:
                    mtl_lib = load_wavefront_mtl(
                        mtl_path,
                        missing_texture_fallback=missing_texture_fallback)
                except FileNotFoundError:
                    if not os.path.exists(mtl_path):
                        warnings.warn(f"mtllib {mtl_path!r} not found")
                        mtl_lib = {}
                    else:
                        raise
            elif key == "usemtl":
                name = parts[1]
                current_material = (mtl_lib or {}).get(name)
                if current_material is None:
                    warnings.warn(f"material {name!r} unresolved; using the "
                                  "magenta debug light")
            elif key == "f":
                corners = []
                for spec in parts[1:]:
                    fields = spec.split("/")
                    vi = _resolve_index(int(fields[0]), len(vertices))
                    ti = ni = None
                    if len(fields) > 1 and fields[1]:
                        ti = _resolve_index(int(fields[1]), len(texcoords))
                    if len(fields) > 2 and fields[2]:
                        ni = _resolve_index(int(fields[2]), len(normals))
                    corners.append((vi, ti, ni))
                # Fan triangulation of polygons.
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    triangles.append(B.Triangle(
                        vertices=tuple(vertices[vi] for vi, _, _ in tri),
                        material=material(),
                        normals=tuple(normals[ni] if ni is not None else None
                                      for _, _, ni in tri),
                        uvs=tuple(texcoords[ti] if ti is not None else None
                                  for _, ti, _ in tri)))
            elif key in ("p", "l"):
                skipped += 1

    if skipped:
        warnings.warn(f"{path}: skipped {skipped} point/line primitives")
    return triangles
