"""The benchmark's inputs: each configuration's scene, drawn from a seed.

A scene is a `SceneDesc` of plain numbers (no tensors, nothing of the
program): the benchmark draws it, hands it to the program through the
program's scene builder (`rtbench.port.build`) and to the plain reference
(`rtbench.reference.render.Tables`), which works out its own tables from it.

The generators follow the two books' final scenes as the reference CLI
builds them (and as the program's `models.scenes` catalog draws them):
`jumpy_balls` is book 1's random-spheres scene with moving spheres and a
hollow glass shell; `book2_final` is The Next Week's final scene. Every
primitive is in world space: a rotated or translated object is given by its
transformed coordinates. A material or texture shared by several
primitives is one entry, named by its index, as the program's builder
interns one object: the two sides' tables then hold the same rows in some
order, so a norm over a table compares across them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

DEFAULT_BACKGROUND = (0.7, 0.8, 1.0)

# A raw file of the repository that both sides read: the earthmap's texels
# (the JPEG decoded once, uint8).
_REPO = os.path.join(os.path.dirname(__file__), "..", "..")
EARTHMAP = os.path.join(_REPO, "raytracer_weekend_tpu_torch", "assets",
                        "earthmap.npz")


@dataclasses.dataclass
class SceneDesc:
    """A scene as plain numbers.

    textures: dicts {"type": "solid"|"checker"|"noise"|"image", "color1",
      "color2", "scale", "image"} ("image" names an entry of `images`).
    materials: dicts {"type": "lambertian"|"metal"|"dielectric"|"light"|
      "isotropic", "tex", "fuzz", "ior"}. A dielectric's white texture is a
      texture entry of its own, as the builder makes one for each.
    spheres: (c0, c1, t0, t1, radius, mat); a static sphere has c1 == c0,
      (t0, t1) = (0, 1).
    rects: (axis, a0, a1, b0, b1, k, mat); axis 0 = YZ, 1 = XZ, 2 = XY.
    triangles: ((v0, v1, v2), (n0, n1, n2), (uv0, uv1, uv2), mat), every
      vertex's normal and uv given.
    volumes: (center, radius, density, mat): sphere-bounded media.
    camera: make_camera's arguments.
    """

    textures: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)
    spheres: list = dataclasses.field(default_factory=list)
    rects: list = dataclasses.field(default_factory=list)
    triangles: list = dataclasses.field(default_factory=list)
    volumes: list = dataclasses.field(default_factory=list)
    images: dict = dataclasses.field(default_factory=dict)
    background: tuple = DEFAULT_BACKGROUND
    camera: dict = dataclasses.field(default_factory=dict)
    perlin_seed: int = 0

    # -- construction helpers -------------------------------------------
    def texture(self, kind, color1=(0.0, 0.0, 0.0), color2=(0.0, 0.0, 0.0),
                scale=0.0, image=None) -> int:
        self.textures.append(dict(type=kind, color1=tuple(map(float, color1)),
                                  color2=tuple(map(float, color2)),
                                  scale=float(scale), image=image))
        return len(self.textures) - 1

    def material(self, kind, tex=None, fuzz=0.0, ior=1.0) -> int:
        if kind == "dielectric":
            tex = self.texture("solid", (1.0, 1.0, 1.0))
        self.materials.append(dict(type=kind, tex=tex, fuzz=float(fuzz),
                                   ior=float(ior)))
        return len(self.materials) - 1

    def solid(self, kind, color, **kw) -> int:
        return self.material(kind, self.texture("solid", color), **kw)

    def sphere(self, center, radius, mat, center1=None, t0=0.0, t1=1.0):
        c0 = tuple(float(x) for x in center)
        c1 = c0 if center1 is None else tuple(float(x) for x in center1)
        self.spheres.append((c0, c1, float(t0), float(t1), float(radius),
                             mat))

    def cuboid(self, p0, p1, mat):
        """An axis-aligned box as its six rects (the builder's order)."""
        x0, y0, z0 = p0
        x1, y1, z1 = p1
        for row in ((2, x0, x1, y0, y1, z1), (2, x0, x1, y0, y1, z0),
                    (1, x0, x1, z0, z1, y1), (1, x0, x1, z0, z1, y0),
                    (0, y0, y1, z0, z1, x1), (0, y0, y1, z0, z1, x0)):
            self.rects.append((row[0], *map(float, row[1:]), mat))

    @property
    def counts(self) -> dict:
        return {"spheres": len(self.spheres), "rects": len(self.rects),
                "triangles": len(self.triangles),
                "volumes": len(self.volumes),
                "materials": len(self.materials),
                "textures": len(self.textures)}


def _camera(look_from, look_at, vfov, aspect, aperture=0.0, focus=10.0,
            up=(0.0, 1.0, 0.0)) -> dict:
    return dict(look_from=tuple(map(float, look_from)),
                look_at=tuple(map(float, look_at)),
                up=tuple(map(float, up)), vfov=float(vfov),
                aspect=float(aspect), aperture=float(aperture),
                focus=float(focus), t0=0.0, t1=1.0)


def _rot_y(theta_deg: float, v: np.ndarray) -> np.ndarray:
    t = math.radians(theta_deg)
    c, s = math.cos(t), math.sin(t)
    return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]])


def jumpy_balls(aspect: float, seed: int) -> SceneDesc:
    """Book 1's final scene: a checker ground, three large spheres (one a
    hollow glass shell), and up to 484 small spheres that move upward over
    the shutter, 80% diffuse, 15% metal, 5% glass."""
    rng = np.random.default_rng(seed)
    s = SceneDesc(perlin_seed=seed)
    checker = s.texture("checker", (0.2, 0.3, 0.1), (0.9, 0.9, 0.9), 10.0)
    ground = s.material("lambertian", checker)
    glass = s.material("dielectric", ior=1.5)
    s.sphere((0, -1000, 0), 1000.0, ground)
    s.sphere((-4, 0.2, 0.1), 1.0, s.solid("lambertian", (0.4, 0.2, 0.1)))
    s.sphere((0, 1, 0), 1.0, glass)
    s.sphere((0, 1, 0), -0.95, glass)
    s.sphere((4, 1, 0), 1.0, s.solid("metal", (0.7, 0.6, 0.5), fuzz=0.0))
    for a in range(-11, 11):
        for b in range(-11, 11):
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            choose = rng.random()
            if choose < 0.8:
                mat = s.solid("lambertian",
                              tuple(rng.random(3) * rng.random(3)))
            elif choose < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                mat = s.solid("metal", albedo, fuzz=rng.uniform(0.0, 0.5))
            else:
                mat = s.material("dielectric", ior=1.5)
            center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
            s.sphere(center, 0.2, mat, center1=center2)
    s.camera = _camera((13, 2, 3), (0, 0, 0), 20.0, aspect, aperture=0.1)
    return s


def earthmap() -> np.ndarray:
    with np.load(EARTHMAP) as z:
        return z["earthmap"].astype(np.float32) / 255.0


def book2_final(aspect: float, seed: int) -> SceneDesc:
    """The Next Week's final scene: 400 ground boxes of random heights, an
    area light, a moving sphere, glass, metal, an earth-textured and a
    Perlin-marble sphere, a blue medium inside a glass sphere, a thin mist
    over everything and a rotated cluster of 1,000 white spheres."""
    rng = np.random.default_rng(seed + 2)
    s = SceneDesc(perlin_seed=seed, background=(0.0, 0.0, 0.0))
    ground = s.solid("lambertian", (0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = rng.uniform(1.0, 101.0)
            s.cuboid((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)
    s.rects.append((1, 123.0, 423.0, 147.0, 412.0, 554.0,
                    s.solid("light", (7.0, 7.0, 7.0))))
    s.sphere((400, 400, 200), 50.0, s.solid("lambertian", (0.7, 0.3, 0.1)),
             center1=(430, 400, 200))
    s.sphere((260, 150, 45), 50.0, s.material("dielectric", ior=1.5))
    s.sphere((0, 150, 145), 50.0, s.solid("metal", (0.8, 0.8, 0.9), fuzz=1.0))
    s.sphere((360, 150, 145), 70.0, s.material("dielectric", ior=1.5))
    s.volumes.append(((360.0, 150.0, 145.0), 70.0, 0.2,
                      s.solid("isotropic", (0.2, 0.4, 0.9))))
    s.volumes.append(((0.0, 0.0, 0.0), 5000.0, 0.0001,
                      s.solid("isotropic", (1.0, 1.0, 1.0))))
    s.images["earthmap"] = earthmap()
    s.sphere((400, 200, 400), 100.0,
             s.material("lambertian", s.texture("image", image="earthmap")))
    s.sphere((220, 280, 300), 80.0,
             s.material("lambertian", s.texture("noise", scale=0.1)))
    white = s.solid("lambertian", (0.73, 0.73, 0.73))
    for _ in range(1000):
        c = rng.uniform(0.0, 165.0, 3)
        s.sphere(_rot_y(15.0, c) + np.array([-100.0, 270.0, 395.0]), 10.0,
                 white)
    look_from, look_at = (478, 278, -600), (278, 278, 0)
    focus = float(np.linalg.norm(np.subtract(look_at, look_from)))
    s.camera = _camera(look_from, look_at, 40.0, aspect, focus=focus)
    return s


def read_obj(path: str, offset, mat: int) -> list:
    """An OBJ file's faces as triangles (fan-triangulated polygons), every
    vertex translated by `offset`, one material. Corners without a normal
    take the face's (v1 - v0) x (v2 - v0), without a uv the defaults
    (0, 0), (1, 0), (0, 1)."""
    verts, norms, uvs, tris = [], [], [], []
    off = np.asarray(offset, np.float64)
    default_uv = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append(np.asarray(parts[1:4], np.float64) + off)
            elif parts[0] == "vn":
                norms.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "vt":
                uvs.append(tuple(float(x) for x in parts[1:3]))
            elif parts[0] == "f":
                corners = []
                for spec in parts[1:]:
                    fields = (spec.split("/") + ["", ""])[:3]
                    idx = [int(x) if x else None for x in fields]
                    corners.append(tuple(
                        None if i is None else (i - 1 if i > 0 else n + i)
                        for i, n in zip(idx, (len(verts), len(uvs),
                                              len(norms)))))
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    v = [verts[c[0]] for c in tri]
                    face_n = tuple(np.cross(v[1] - v[0], v[2] - v[0]))
                    tris.append((
                        tuple(tuple(x) for x in v),
                        tuple(norms[c[2]] if c[2] is not None else face_n
                              for c in tri),
                        tuple(uvs[c[1]] if c[1] is not None
                              else default_uv[j] for j, c in enumerate(tri)),
                        mat))
    return tris


def _rect_triangles(axis, a0, a1, b0, b1, k, theta, offset):
    """A rect under a Y rotation and a translation as its two triangles
    (the program's builder's rule): corners in UV order, uvs exact, the
    rotated axis normal at every vertex."""
    a_ax, b_ax = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[axis]
    pts = []
    for a, b in ((a0, b0), (a1, b0), (a1, b1), (a0, b1)):
        q = np.zeros(3)
        q[a_ax], q[b_ax], q[axis] = a, b, k
        pts.append(_rot_y(theta, q) + np.asarray(offset, np.float64))
    n = np.zeros(3)
    n[axis] = 1.0
    n = tuple(_rot_y(theta, n))
    uvs = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
    return [(tuple(tuple(pts[i]) for i in ids), (n, n, n),
             tuple(uvs[i] for i in ids)) for ids in ((0, 1, 2), (0, 2, 3))]


def from_file(path: str, aspect: float, seed: int) -> SceneDesc:
    """A fixed scene from a JSON file (a configuration's `scene_file`):
    `textures` and `materials` (as `SceneDesc` states them; a dielectric
    gets its white texture after the listed ones), `spheres`, `rects`,
    `cuboids` ([p0, p1, mat, theta_deg, offset]: rects, or under a rotation
    the builder's triangles), `meshes` ({"obj": path from the repository's
    root, "offset", "mat"}), `volumes`, `images` ({"earthmap": "earthmap"}),
    `background` and `camera` (make_camera's arguments but `aspect`). The
    seed draws nothing; it keys the Perlin tables."""
    with open(path) as f:
        spec = json.load(f)
    s = SceneDesc(perlin_seed=seed,
                  background=tuple(spec.get("background",
                                            DEFAULT_BACKGROUND)))
    for t in spec.get("textures", []):
        s.texture(t["type"], t.get("color1", (0, 0, 0)),
                  t.get("color2", (0, 0, 0)), t.get("scale", 0.0),
                  t.get("image"))
    for m in spec.get("materials", []):
        s.material(m["type"], m.get("tex"), m.get("fuzz", 0.0),
                   m.get("ior", 1.0))
    for c0, c1, t0, t1, r, mat in spec.get("spheres", []):
        s.sphere(c0, r, mat, center1=c1, t0=t0, t1=t1)
    for row in spec.get("rects", []):
        s.rects.append((int(row[0]), *map(float, row[1:6]), int(row[6])))
    for p0, p1, mat, theta, offset in spec.get("cuboids", []):
        if theta == 0.0:
            s.cuboid(np.add(p0, offset), np.add(p1, offset), mat)
            continue
        n0 = len(s.rects)
        s.cuboid(p0, p1, mat)
        sides, s.rects[n0:] = s.rects[n0:], []
        for axis, a0, a1, b0, b1, k, m in sides:
            s.triangles += [(*tri, m) for tri in _rect_triangles(
                axis, a0, a1, b0, b1, k, theta, offset)]
    for mesh in spec.get("meshes", []):
        s.triangles += read_obj(os.path.join(_REPO, mesh["obj"]),
                                mesh.get("offset", (0, 0, 0)), mesh["mat"])
    for center, radius, density, mat in spec.get("volumes", []):
        s.volumes.append((tuple(map(float, center)), float(radius),
                          float(density), mat))
    for name, source in spec.get("images", {}).items():
        if source != "earthmap":
            raise ValueError(f"image {name!r}: only the earthmap is known")
        s.images[name] = earthmap()
    cam = dict(spec["camera"])
    s.camera = _camera(cam["look_from"], cam["look_at"], cam["vfov"], aspect,
                       cam.get("aperture", 0.0), cam.get("focus", 10.0),
                       cam.get("up", (0.0, 1.0, 0.0)))
    return s


SCENES = {"jumpy_balls": jumpy_balls, "book2_final": book2_final}


def make_scene(config: dict) -> SceneDesc:
    """The configuration's scene: its `scene_file` (a path from the
    repository's root), else its built-in generator `scene`, drawn from the
    configuration's `scene_seed`: one scene, whatever the run's seed."""
    aspect, seed = config["width"] / config["height"], config["scene_seed"]
    if "scene_file" in config:
        return from_file(os.path.join(_REPO, config["scene_file"]), aspect,
                         seed)
    if config["scene"] not in SCENES:
        raise KeyError(f"unknown scene generator {config['scene']!r}; "
                       f"known: {sorted(SCENES)}")
    return SCENES[config["scene"]](aspect, seed)
