"""Scene-construction DSL that compiles to SoA tables (spheres and planar family).

Port of `raytracer_weekend_tpu/scene/builder.py`, in numpy up to the final
tensors, so that the port builds scenes without jax. It covers `SolidColor`,
`Checker`, `NoiseTexture`, `ImageTexture`, `UVDebug`, `Lambertian`,
`Metal`, `Dielectric`, `DiffuseLight`, `Isotropic`, `Sphere`,
`MovingSphere`, the axis-aligned rectangles, `Cuboid`, `Triangle` and
`ConstantMedium` (a Sphere or Cuboid boundary), with the fluent
`.rotate_y(deg).translate(offset)` transform on every geometry class. Table
order, material and texture interning, Morton order, the image atlas and
the `SceneStatic` flags are the JAX builder's, so both builders give
bit-equal tables for the same objects, and bit-equal trees (`bvh="auto"`:
a sphere tree above 512 spheres, a triangle tree above 64 triangles, built
by the port's copy of the C++ builder, `native.build_bvh`).

Bake rules, as in the JAX builder: sphere centers and triangle vertices and
normals are transformed; a rect or cuboid under a pure translation stays a
rect with shifted bounds, and a rotated one becomes 2 triangles per rect
with exact UVs and a constant normal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from raytracer_weekend_tpu_torch import materials as mat_mod
from raytracer_weekend_tpu_torch import perlin as perlin_mod
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.materials import MaterialTable
from raytracer_weekend_tpu_torch.ops.bvh import Bvh
from raytracer_weekend_tpu_torch.scene.data import (
    VOL_BOX, VOL_SPHERE, Rects, SceneData, SceneStatic, Spheres, Triangles,
    Volumes)
from raytracer_weekend_tpu_torch.textures import TextureTable


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolidColor:
    color: tuple


@dataclasses.dataclass(frozen=True)
class Checker:
    """3D sine-product checker. Children must be solid colors."""
    even: SolidColor
    odd: SolidColor
    frequency: float


@dataclasses.dataclass(frozen=True)
class NoiseTexture:
    """Perlin marble with frequency `scale`."""
    scale: float


class ImageTexture:
    """Bitmap texture. `data` is (H, W, 3) float in [0, 1].

    With a `path` the file is decoded with Pillow, as the JAX builder does
    (RGB, float32 / 255); without Pillow that raises `ImportError`. The
    catalog's earthmap comes decoded with the package
    (`models.scenes.earthmap`), so it needs no decoder.
    """

    def __init__(self, path: str | None = None, data=None):
        if data is None:
            if path is None:
                raise ValueError("ImageTexture needs a path or an array")
            from PIL import Image

            with Image.open(path) as im:
                data = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        self.data = np.asarray(data, dtype=np.float32)
        if self.data.ndim != 3 or self.data.shape[-1] != 3:
            raise ValueError(f"image must be (H,W,3), got {self.data.shape}")
        self.path = path


@dataclasses.dataclass(frozen=True)
class UVDebug:
    """(u, v, 0) debug texture."""


def _as_texture(value):
    """Accept bare color tuples anywhere a texture is expected."""
    if isinstance(value, (tuple, list)) and len(value) == 3:
        return SolidColor(tuple(float(x) for x in value))
    return value


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

class _Material:
    pass


class Lambertian(_Material):
    def __init__(self, albedo):
        self.albedo = _as_texture(albedo)


class Metal(_Material):
    def __init__(self, albedo, fuzz: float):
        if fuzz > 1.0:
            raise ValueError("fuzz must be <= 1")
        self.albedo = _as_texture(albedo)
        self.fuzz = float(fuzz)


class Dielectric(_Material):
    def __init__(self, index_of_refraction: float):
        self.ior = float(index_of_refraction)


class DiffuseLight(_Material):
    def __init__(self, emit):
        self.emit = _as_texture(emit)


class Isotropic(_Material):
    def __init__(self, albedo):
        self.albedo = _as_texture(albedo)


# ---------------------------------------------------------------------------
# Rigid Y-rotation + translation transform
# ---------------------------------------------------------------------------

def _rot_y(theta_deg: float, v: np.ndarray) -> np.ndarray:
    """World = R(theta) * object."""
    t = math.radians(theta_deg)
    c, s = math.cos(t), math.sin(t)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


class _Transformable:
    """Fluent `.rotate_y(deg).translate(offset)`: each geometry object
    carries one composed rigid transform world = R(theta) x + offset."""

    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)

    def _with_transform(self, theta, offset):
        clone = dataclasses.replace(self)
        object.__setattr__(clone, "theta", theta)
        object.__setattr__(clone, "offset", tuple(offset))
        return clone

    def rotate_y(self, angle_degrees: float):
        new_offset = _rot_y(angle_degrees, np.asarray(self.offset, np.float64))
        return self._with_transform(self.theta + angle_degrees,
                                    tuple(new_offset))

    def translate(self, offset):
        off = np.asarray(self.offset, np.float64) + np.asarray(offset,
                                                               np.float64)
        return self._with_transform(self.theta, tuple(off))

    def _apply(self, pts: np.ndarray) -> np.ndarray:
        return _rot_y(self.theta, pts) + np.asarray(self.offset, np.float64)

    def _apply_vec(self, vecs: np.ndarray) -> np.ndarray:
        return _rot_y(self.theta, vecs)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sphere(_Transformable):
    center: tuple
    radius: float
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class MovingSphere(_Transformable):
    """Linear center motion over [time0, time1]."""
    center0: tuple
    time0: float
    center1: tuple
    time1: float
    radius: float
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class _Rect(_Transformable):
    """axis = fixed coordinate (0=YZ, 1=XZ, 2=XY); (a, b) in UV order."""
    axis: int
    a0: float
    a1: float
    b0: float
    b1: float
    k: float
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


def XYRectangle(x0, x1, y0, y1, k, material) -> _Rect:
    return _Rect(2, x0, x1, y0, y1, k, material)


def XZRectangle(x0, x1, z0, z1, k, material) -> _Rect:
    return _Rect(1, x0, x1, z0, z1, k, material)


def YZRectangle(y0, y1, z0, z1, k, material) -> _Rect:
    return _Rect(0, y0, y1, z0, z1, k, material)


@dataclasses.dataclass(frozen=True)
class Cuboid(_Transformable):
    """Axis-aligned box = 6 rects."""
    p0: tuple
    p1: tuple
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)

    def sides(self) -> list[_Rect]:
        x0, y0, z0 = self.p0
        x1, y1, z1 = self.p1
        m = self.material
        rects = [
            XYRectangle(x0, x1, y0, y1, z1, m),
            XYRectangle(x0, x1, y0, y1, z0, m),
            XZRectangle(x0, x1, z0, z1, y1, m),
            XZRectangle(x0, x1, z0, z1, y0, m),
            YZRectangle(y0, y1, z0, z1, x1, m),
            YZRectangle(y0, y1, z0, z1, x0, m),
        ]
        return [r._with_transform(self.theta, self.offset) for r in rects]


@dataclasses.dataclass(frozen=True)
class Triangle(_Transformable):
    """Normals/UVs entries may be None: the face normal and the default UVs
    ((0,0), (1,0), (0,1)) stand in for them."""
    vertices: tuple  # 3 x (3,)
    material: _Material
    normals: tuple = (None, None, None)
    uvs: tuple = (None, None, None)
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)

    @classmethod
    def flat_shaded(cls, vertices, material):
        return cls(tuple(tuple(v) for v in vertices), material)


@dataclasses.dataclass(frozen=True)
class ConstantMedium(_Transformable):
    """A constant-density medium inside a Sphere or Cuboid boundary (either
    possibly transformed), with an isotropic phase function over
    `texture`."""
    boundary: object
    density: float
    texture: object
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

_DEFAULT_UVS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))

_RECT_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # fixed axis -> (a_axis, b_axis)


def build_scene(objects: Sequence, background=(0.7, 0.8, 1.0),
                seed: int = 0,
                bvh: str | bool = "auto") -> tuple[SceneData, SceneStatic]:
    """Compile DSL objects -> (SceneData on the CPU, SceneStatic).

    `bvh` as in the JAX builder: "auto" records a skip-link tree over the
    spheres above 512 of them and over the triangles above 64, True over
    every non-empty family, False none; `SceneStatic.sphere_bvh` and
    `triangle_bvh` say which were built. The fused megakernel never reads
    a tree. The staged path walks a tree where `integrator._closest_hit`
    takes it (the plain `ops.bvh.traverse`, or the BVH kernel on a card);
    its leaf tests write the quadratic in another order than the brute
    force, and on an exact tie the first leaf in DFS order keeps the lane
    where the brute force keeps the lowest row, so the two agree to
    rounding and up to ties.
    """
    from raytracer_weekend_tpu_torch.utils import metrics

    with metrics.setup_span("rtw.setup.scene"):
        comp = _Compiler(seed)
        for obj in objects:
            comp.add(obj)
        return comp.finish(background, bvh)


def _sphere_bvh(spheres: Spheres) -> Bvh:
    """The sphere tree over boxes that hold each sphere over the whole
    shutter motion; |radius| guards the hollow-glass negative radii, which
    would invert the reference's box."""
    from raytracer_weekend_tpu_torch.native import build_bvh

    c0, c1 = spheres.c0.numpy(), spheres.c1.numpy()
    r = np.abs(spheres.radius.numpy())[:, None]
    lo = np.minimum(c0 - r, c1 - r)
    hi = np.maximum(c0 + r, c1 + r)
    return Bvh(*map(torch.from_numpy, build_bvh(lo, hi)))


def _triangle_bvh(tris: Triangles) -> Bvh:
    """The triangle tree over the triangles' boxes, padded by +-1e-4 where
    an axis's extent is under 2e-4 (the reference's thin-extent padding)."""
    from raytracer_weekend_tpu_torch.native import build_bvh

    v = np.stack([tris.v0.numpy(), tris.v1.numpy(), tris.v2.numpy()],
                 axis=1)                                   # (T,3,3)
    lo = v.min(axis=1)
    hi = v.max(axis=1)
    thin = (hi - lo) < 2e-4
    lo = np.where(thin, lo - 1e-4, lo)
    hi = np.where(thin, hi + 1e-4, hi)
    return Bvh(*map(torch.from_numpy, build_bvh(lo, hi)))


class _Compiler:
    def __init__(self, seed: int):
        self.seed = seed
        # material/texture interning by object identity
        self.mat_ids: dict[int, int] = {}
        self.mats: list[_Material] = []
        self.tex_ids: dict[int, int] = {}
        self.texs: list = []
        self.sph: list = []
        self.rect: list = []
        self.tri: list = []
        self.vol: list = []

    def _texture_id(self, tex) -> int:
        tex = _as_texture(tex)
        key = id(tex)
        if key in self.tex_ids:
            return self.tex_ids[key]
        tid = len(self.texs)
        self.texs.append(tex)
        self.tex_ids[key] = tid
        return tid

    def _material_id(self, mat: _Material) -> int:
        key = id(mat)
        if key in self.mat_ids:
            return self.mat_ids[key]
        mid = len(self.mats)
        self.mats.append(mat)
        self.mat_ids[key] = mid
        return mid

    # -- geometry lowering -------------------------------------------------

    def add(self, obj):
        if isinstance(obj, Sphere):
            c = obj._apply(np.asarray(obj.center, np.float64))
            self.sph.append((c, c, 0.0, 1.0, obj.radius,
                             self._material_id(obj.material)))
        elif isinstance(obj, MovingSphere):
            c0 = obj._apply(np.asarray(obj.center0, np.float64))
            c1 = obj._apply(np.asarray(obj.center1, np.float64))
            self.sph.append((c0, c1, obj.time0, obj.time1, obj.radius,
                             self._material_id(obj.material)))
        elif isinstance(obj, _Rect):
            self._add_rect(obj)
        elif isinstance(obj, Cuboid):
            for side in obj.sides():
                self._add_rect(side)
        elif isinstance(obj, Triangle):
            self._add_triangle(obj)
        elif isinstance(obj, ConstantMedium):
            self._add_medium(obj)
        elif isinstance(obj, (list, tuple)):
            for sub in obj:
                self.add(sub)
        else:
            raise NotImplementedError(
                f"scene object {type(obj).__name__} is not supported")

    def _add_rect(self, r: _Rect):
        mid = self._material_id(r.material)
        a_ax, b_ax = _RECT_AXES[r.axis]
        if r.theta == 0.0:
            # A pure translation keeps the rect axis-aligned: shift bounds.
            off = np.asarray(r.offset, np.float64)
            self.rect.append((r.axis, r.a0 + off[a_ax], r.a1 + off[a_ax],
                              r.b0 + off[b_ax], r.b1 + off[b_ax],
                              r.k + off[r.axis], mid))
            return
        # A rotated rect -> 2 triangles with exact UVs and a constant normal.
        corners_ab = [(r.a0, r.b0), (r.a1, r.b0), (r.a1, r.b1), (r.a0, r.b1)]
        uvs = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
        pts = []
        for a, b in corners_ab:
            p = np.zeros(3)
            p[a_ax] = a
            p[b_ax] = b
            p[r.axis] = r.k
            pts.append(p)
        pts = r._apply(np.stack(pts))
        normal = np.zeros(3)
        normal[r.axis] = 1.0
        normal = r._apply_vec(normal)
        n3 = (tuple(normal),) * 3
        for ids in ((0, 1, 2), (0, 2, 3)):
            self.tri.append((tuple(tuple(pts[i]) for i in ids), n3,
                             tuple(uvs[i] for i in ids), mid))

    def _add_triangle(self, t: Triangle):
        verts = t._apply(np.asarray([np.asarray(v, np.float64)
                                     for v in t.vertices]))
        face_n = np.cross(verts[1] - verts[0], verts[2] - verts[0])
        normals = [face_n if n is None
                   else t._apply_vec(np.asarray(n, np.float64))
                   for n in t.normals]
        uvs = tuple(tuple(uv) if uv is not None else _DEFAULT_UVS[i]
                    for i, uv in enumerate(t.uvs))
        self.tri.append((tuple(tuple(v) for v in verts),
                         tuple(tuple(n) for n in normals), uvs,
                         self._material_id(t.material)))

    def _add_medium(self, m: ConstantMedium):
        mid = self._material_id(Isotropic(m.texture))
        neg_inv_density = -1.0 / m.density
        b = m.boundary
        # The medium's own transform composes outside the boundary's:
        # world = Rm (Rb x + tb) + tm.
        if isinstance(b, Sphere):
            center = m._apply(b._apply(np.asarray(b.center, np.float64)))
            self.vol.append((VOL_SPHERE, tuple(center), b.radius,
                             (0, 0, 0), (1, 1, 1), 0.0, (0, 0, 0),
                             neg_inv_density, mid))
        elif isinstance(b, Cuboid):
            offset = m._apply(np.asarray(b.offset, np.float64))
            self.vol.append((VOL_BOX, (0, 0, 0), 1.0, tuple(b.p0),
                             tuple(b.p1), m.theta + b.theta, tuple(offset),
                             neg_inv_density, mid))
        else:
            raise TypeError(f"ConstantMedium boundary must be Sphere or "
                            f"Cuboid, got {type(b)}")

    # -- table emission ----------------------------------------------------

    @staticmethod
    def _morton_argsort(cent: np.ndarray) -> np.ndarray:
        """Z-order permutation of (N, 3) centroids (10 bits/axis)."""
        c = np.asarray(cent, np.float64)
        lo = c.min(axis=0)
        span = c.max(axis=0) - lo
        q = ((c - lo) / np.where(span == 0, 1.0, span) * 1023.0).astype(
            np.uint64)

        def spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(
            q[:, 2])
        return np.argsort(code, kind="stable")

    def _sort_spatially(self):
        """Morton-order spheres, rects and triangles (volumes keep their
        order: the random stream salts by volume index)."""
        if len(self.sph) > 1:
            cent = np.asarray([(np.asarray(c0) + np.asarray(c1)) / 2
                               for c0, c1, *_ in self.sph])
            self.sph = [self.sph[i] for i in self._morton_argsort(cent)]
        if len(self.rect) > 1:
            cent = []
            for axis, a0, a1, b0, b1, k, _ in self.rect:
                a_ax, b_ax = _RECT_AXES[axis]
                p = np.zeros(3)
                p[a_ax] = (a0 + a1) / 2
                p[b_ax] = (b0 + b1) / 2
                p[axis] = k
                cent.append(p)
            self.rect = [self.rect[i]
                         for i in self._morton_argsort(np.asarray(cent))]
        if len(self.tri) > 1:
            cent = np.asarray([np.mean(np.asarray(v), axis=0)
                               for v, _, _, _ in self.tri])
            self.tri = [self.tri[i] for i in self._morton_argsort(cent)]

    def finish(self, background,
               bvh: str | bool = "auto") -> tuple[SceneData, SceneStatic]:
        self._sort_spatially()
        n_spheres, n_rects, n_tris = len(self.sph), len(self.rect), len(
            self.tri)
        n_vols = len(self.vol)

        spheres = self._emit_spheres()
        rects = self._emit_rects()
        tris = self._emit_triangles()
        vols = self._emit_volumes()
        materials, textures, has_noise, has_image = self._emit_shading()
        want_sphere_bvh = (bvh is True) or (bvh == "auto" and n_spheres > 512)
        want_tri_bvh = (bvh is True) or (bvh == "auto" and n_tris > 64)
        data = SceneData(
            spheres=spheres, rects=rects, triangles=tris, volumes=vols,
            materials=materials, textures=textures,
            background=torch.tensor(background, dtype=torch.float32),
            sphere_bvh=_sphere_bvh(spheres) if (
                want_sphere_bvh and n_spheres) else None,
            triangle_bvh=_triangle_bvh(tris) if (
                want_tri_bvh and n_tris) else None)

        # Fused-megakernel eligibility, the JAX rule: Lambertian/Metal/
        # Dielectric/DiffuseLight materials everywhere; solid, checker, noise
        # and image textures everywhere (noise and image run in the kernel's
        # deferred-texture mode), and UV-debug textures on planar primitives
        # only (their UVs come from the planar table; a sphere's spherical
        # UV is not in the kernel); constant media qualify when their
        # isotropic phase texture is a solid color (every catalog scene's).
        mtype = materials.mtype.numpy()
        ttype = textures.ttype.numpy()
        tex_of = materials.tex.numpy()
        fused_simple = False
        if n_spheres or n_rects or n_tris:
            ok = True
            for present, fam, allowed in ((n_spheres, spheres, (0, 1, 2, 3)),
                                          (n_rects, rects, (0, 1, 2, 3, 4)),
                                          (n_tris, tris, (0, 1, 2, 3, 4))):
                if present:
                    m = fam.mat.numpy()[fam.valid.numpy()]
                    ok &= bool(np.all(np.isin(mtype[m], (0, 1, 2, 3)))
                               and np.all(np.isin(ttype[tex_of[m]], allowed)))
            if n_vols:
                m = vols.mat.numpy()[vols.valid.numpy()]
                ok &= bool(np.all(mtype[m] == mat_mod.ISOTROPIC)
                           and np.all(ttype[tex_of[m]] == tex_mod.SOLID))
            fused_simple = ok

        # Single-deferred-hit eligibility: one sphere, nothing else, an image
        # texture, a material that cannot re-enter the body (a Lambertian or
        # metal scatter from a convex surface points outward, so a path
        # meets the sphere at most once; dielectrics refract through).
        defer_single_hit = False
        if (has_image and not has_noise and n_spheres == 1
                and n_rects + n_tris + n_vols == 0):
            mt0 = int(mtype[int(spheres.mat[0])])
            defer_single_hit = mt0 in (mat_mod.LAMBERTIAN, mat_mod.METAL,
                                       mat_mod.DIFFUSE_LIGHT)

        static = SceneStatic(
            n_spheres=n_spheres, n_rects=n_rects, n_triangles=n_tris,
            n_volumes=n_vols, has_noise=has_noise, has_image=has_image,
            has_uvdebug=bool(np.any(ttype == tex_mod.UVDEBUG)),
            defer_single_hit=defer_single_hit,
            sphere_bvh=data.sphere_bvh is not None,
            triangle_bvh=data.triangle_bvh is not None,
            fused_simple=fused_simple)
        return data, static

    def _emit_spheres(self) -> Spheres:
        rows = self.sph or [((0, 1e9, 0), (0, 1e9, 0), 0.0, 1.0, 1.0, 0)]
        pad = not self.sph
        c0 = np.asarray([r[0] for r in rows], np.float32)
        c1 = np.asarray([r[1] for r in rows], np.float32)
        t0 = np.asarray([r[2] for r in rows], np.float32)
        t1 = np.asarray([r[3] for r in rows], np.float32)
        rad = np.asarray([r[4] for r in rows], np.float32)
        mat = np.asarray([r[5] for r in rows], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        return Spheres(*map(torch.from_numpy,
                            (c0, c1, t0, t1, rad, mat, valid)))

    def _emit_rects(self) -> Rects:
        rows = self.rect or [(2, 0.0, 1.0, 0.0, 1.0, 0.0, 0)]
        pad = not self.rect
        cols = list(zip(*rows))
        axis = np.asarray(cols[0], np.int32)
        a0, a1, b0, b1, k = (np.asarray(c, np.float32) for c in cols[1:6])
        mat = np.asarray(cols[6], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        return Rects(*map(torch.from_numpy,
                          (axis, a0, a1, b0, b1, k, mat, valid)))

    def _emit_triangles(self) -> Triangles:
        rows = self.tri or [
            (((0, 0, 0), (1, 0, 0), (0, 1, 0)),
             ((0, 0, 1),) * 3, _DEFAULT_UVS, 0)
        ]
        pad = not self.tri
        verts = np.asarray([r[0] for r in rows], np.float32)   # (T,3,3)
        norms = np.asarray([r[1] for r in rows], np.float32)
        uvs = np.asarray([r[2] for r in rows], np.float32)      # (T,3,2)
        mat = np.asarray([r[3] for r in rows], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        t = torch.from_numpy
        return Triangles(
            v0=t(verts[:, 0].copy()), v1=t(verts[:, 1].copy()),
            v2=t(verts[:, 2].copy()),
            n0=t(norms[:, 0].copy()), n1=t(norms[:, 1].copy()),
            n2=t(norms[:, 2].copy()),
            uv0=t(uvs[:, 0].copy()), uv1=t(uvs[:, 1].copy()),
            uv2=t(uvs[:, 2].copy()), mat=t(mat), valid=t(valid))

    def _emit_shading(self):
        if not self.mats:
            self.mats.append(Lambertian((0.5, 0.5, 0.5)))

        mtypes, texids, fuzz, ior = [], [], [], []
        for m in self.mats:
            if isinstance(m, Lambertian):
                mtypes.append(mat_mod.LAMBERTIAN)
                texids.append(self._texture_id(m.albedo))
                fuzz.append(0.0)
                ior.append(1.0)
            elif isinstance(m, Metal):
                mtypes.append(mat_mod.METAL)
                texids.append(self._texture_id(m.albedo))
                fuzz.append(m.fuzz)
                ior.append(1.0)
            elif isinstance(m, Dielectric):
                mtypes.append(mat_mod.DIELECTRIC)
                texids.append(self._texture_id(SolidColor((1.0, 1.0, 1.0))))
                fuzz.append(0.0)
                ior.append(m.ior)
            elif isinstance(m, DiffuseLight):
                mtypes.append(mat_mod.DIFFUSE_LIGHT)
                texids.append(self._texture_id(m.emit))
                fuzz.append(0.0)
                ior.append(1.0)
            elif isinstance(m, Isotropic):
                mtypes.append(mat_mod.ISOTROPIC)
                texids.append(self._texture_id(m.albedo))
                fuzz.append(0.0)
                ior.append(1.0)
            else:
                raise NotImplementedError(
                    f"material {type(m).__name__} is not supported")

        materials = MaterialTable(
            mtype=torch.tensor(mtypes, dtype=torch.int32),
            tex=torch.tensor(texids, dtype=torch.int32),
            fuzz=torch.from_numpy(np.asarray(fuzz, np.float32)),
            ior=torch.from_numpy(np.asarray(ior, np.float32)),
        )

        # Texture table. Checker children are folded into color1/color2.
        K = len(self.texs)
        ttype = np.zeros(K, np.int32)
        color1 = np.zeros((K, 3), np.float32)
        color2 = np.zeros((K, 3), np.float32)
        scale = np.zeros(K, np.float32)
        image_id = np.zeros(K, np.int32)
        images: list[np.ndarray] = []
        has_noise = False
        for i, t in enumerate(self.texs):
            if isinstance(t, SolidColor):
                ttype[i] = tex_mod.SOLID
                color1[i] = t.color
            elif isinstance(t, Checker):
                even = _as_texture(t.even)
                odd = _as_texture(t.odd)
                if not (isinstance(even, SolidColor)
                        and isinstance(odd, SolidColor)):
                    raise TypeError("Checker children must be solid colors")
                ttype[i] = tex_mod.CHECKER
                color1[i] = even.color
                color2[i] = odd.color
                scale[i] = t.frequency
            elif isinstance(t, NoiseTexture):
                ttype[i] = tex_mod.NOISE
                scale[i] = t.scale
                has_noise = True
            elif isinstance(t, ImageTexture):
                ttype[i] = tex_mod.IMAGE
                image_id[i] = len(images)
                images.append(t.data)
            elif isinstance(t, UVDebug):
                ttype[i] = tex_mod.UVDEBUG
            else:
                raise NotImplementedError(
                    f"texture {type(t).__name__} is not supported")

        # The image atlas: every image padded to the largest height and width.
        has_image = bool(images)
        if images:
            max_h = max(im.shape[0] for im in images)
            max_w = max(im.shape[1] for im in images)
            atlas = np.zeros((len(images), max_h, max_w, 3), np.float32)
            hw = np.zeros((len(images), 2), np.int32)
            for i, im in enumerate(images):
                atlas[i, :im.shape[0], :im.shape[1]] = im
                hw[i] = im.shape[:2]
        else:
            atlas = np.zeros((1, 1, 1, 3), np.float32)
            hw = np.ones((1, 2), np.int32)

        grad, perm = perlin_mod.make_perlin_tables(self.seed)
        textures = TextureTable(
            ttype=torch.from_numpy(ttype), color1=torch.from_numpy(color1),
            color2=torch.from_numpy(color2), scale=torch.from_numpy(scale),
            image_id=torch.from_numpy(image_id),
            perlin_grad=torch.from_numpy(grad), perlin_perm=torch.from_numpy(perm),
            images=torch.from_numpy(atlas), image_hw=torch.from_numpy(hw),
        )
        return materials, textures, has_noise, has_image


    def _emit_volumes(self) -> Volumes:
        """The volume table; without volumes one invalid row, exactly as the
        JAX builder emits it."""
        rows = self.vol or [(VOL_SPHERE, (0, 1e9, 0), 1.0, (0, 0, 0),
                             (1, 1, 1), 0.0, (0, 0, 0), -1.0, 0)]
        cols = list(zip(*rows))
        theta = np.radians(np.asarray(cols[5], np.float64))
        valid = (np.ones(len(rows), bool) if self.vol
                 else np.zeros(1, bool))
        t = torch.from_numpy
        return Volumes(
            vtype=t(np.asarray(cols[0], np.int32)),
            center=t(np.asarray(cols[1], np.float32)),
            radius=t(np.asarray(cols[2], np.float32)),
            bmin=t(np.asarray(cols[3], np.float32)),
            bmax=t(np.asarray(cols[4], np.float32)),
            cos_t=t(np.cos(theta).astype(np.float32)),
            sin_t=t(np.sin(theta).astype(np.float32)),
            offset=t(np.asarray(cols[6], np.float32)),
            neg_inv_density=t(np.asarray(cols[7], np.float32)),
            mat=t(np.asarray(cols[8], np.int32)), valid=t(valid))
