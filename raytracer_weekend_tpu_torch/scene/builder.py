"""Scene-construction DSL that compiles to SoA tables (sphere subset).

Port of the sphere part of `raytracer_weekend_tpu/scene/builder.py`, in
numpy up to the final tensors, so that the port builds scenes without jax.
It covers `SolidColor`, `Checker`, `Lambertian`, `Metal`, `Dielectric`,
`DiffuseLight`, `Sphere` and `MovingSphere`. Table order, material and
texture interning, Morton order and the `SceneStatic` flags are the JAX
builder's, so both builders give bit-equal tables for the same objects.
Any other object raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from raytracer_weekend_tpu_torch import materials as mat_mod
from raytracer_weekend_tpu_torch import perlin as perlin_mod
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.materials import MaterialTable
from raytracer_weekend_tpu_torch.scene.data import (
    VOL_SPHERE, Rects, SceneData, SceneStatic, Spheres, Triangles, Volumes)
from raytracer_weekend_tpu_torch.textures import TextureTable

_NOT_PORTED = "not ported yet (ROADMAP Queue 1: planar, volumes, textures, BVH)"

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


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sphere:
    center: tuple
    radius: float
    material: _Material


@dataclasses.dataclass(frozen=True)
class MovingSphere:
    """Linear center motion over [time0, time1]."""
    center0: tuple
    time0: float
    center1: tuple
    time1: float
    radius: float
    material: _Material


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def build_scene(objects: Sequence, background=(0.7, 0.8, 1.0),
                seed: int = 0,
                bvh: str | bool = "auto") -> tuple[SceneData, SceneStatic]:
    """Compile DSL objects -> (SceneData on the CPU, SceneStatic).

    `bvh` keeps the JAX signature: the JAX builder attaches a sphere BVH
    above 512 spheres ("auto") or always (True). BVHs are not ported, so a
    scene that would get one raises instead of silently differing.
    """
    comp = _Compiler(seed)
    for obj in objects:
        comp.add(obj)
    n = len(comp.sph)
    if n and (bvh is True or (bvh == "auto" and n > 512)):
        raise NotImplementedError(f"sphere BVH (n_spheres={n}) {_NOT_PORTED}")
    return comp.finish(background)


class _Compiler:
    def __init__(self, seed: int):
        self.seed = seed
        # material/texture interning by object identity
        self.mat_ids: dict[int, int] = {}
        self.mats: list[_Material] = []
        self.tex_ids: dict[int, int] = {}
        self.texs: list = []
        self.sph: list = []

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

    def add(self, obj):
        if isinstance(obj, Sphere):
            c = np.asarray(obj.center, np.float64)
            self.sph.append((c, c, 0.0, 1.0, obj.radius,
                             self._material_id(obj.material)))
        elif isinstance(obj, MovingSphere):
            c0 = np.asarray(obj.center0, np.float64)
            c1 = np.asarray(obj.center1, np.float64)
            self.sph.append((c0, c1, obj.time0, obj.time1, obj.radius,
                             self._material_id(obj.material)))
        elif isinstance(obj, (list, tuple)):
            for sub in obj:
                self.add(sub)
        else:
            raise NotImplementedError(
                f"scene object {type(obj).__name__} {_NOT_PORTED}")

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

    def finish(self, background) -> tuple[SceneData, SceneStatic]:
        if len(self.sph) > 1:
            cent = np.asarray([(np.asarray(c0) + np.asarray(c1)) / 2
                               for c0, c1, *_ in self.sph])
            self.sph = [self.sph[i] for i in self._morton_argsort(cent)]
        n_spheres = len(self.sph)

        spheres = self._emit_spheres()
        materials, textures = self._emit_shading()
        data = SceneData(
            spheres=spheres, rects=_dummy_rects(), triangles=_dummy_triangles(),
            volumes=_dummy_volumes(), materials=materials, textures=textures,
            background=torch.tensor(background, dtype=torch.float32))

        # Every material and texture this builder accepts qualifies for the
        # JAX fused megakernel, and the ones it rejects (noise, image and
        # uv-debug textures, isotropic media, BVHs) are what the other flags
        # record; so fused_simple is "has geometry" and those flags are False.
        static = SceneStatic(
            n_spheres=n_spheres, n_rects=0, n_triangles=0, n_volumes=0,
            has_noise=False, has_image=False, fused_simple=n_spheres > 0)
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
            else:
                raise NotImplementedError(
                    f"material {type(m).__name__} {_NOT_PORTED}")

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
            else:
                raise NotImplementedError(
                    f"texture {type(t).__name__} {_NOT_PORTED}")

        grad, perm = perlin_mod.make_perlin_tables(self.seed)
        textures = TextureTable(
            ttype=torch.from_numpy(ttype), color1=torch.from_numpy(color1),
            color2=torch.from_numpy(color2), scale=torch.from_numpy(scale),
            image_id=torch.zeros(K, dtype=torch.int32),
            perlin_grad=torch.from_numpy(grad), perlin_perm=torch.from_numpy(perm),
            images=torch.zeros((1, 1, 1, 3), dtype=torch.float32),
            image_hw=torch.ones((1, 2), dtype=torch.int32),
        )
        return materials, textures


# Empty-family dummy rows, exactly as the JAX builder emits them.

def _dummy_rects() -> Rects:
    f32, i32 = torch.float32, torch.int32
    return Rects(axis=torch.tensor([2], dtype=i32),
                 a0=torch.tensor([0.0], dtype=f32), a1=torch.tensor([1.0], dtype=f32),
                 b0=torch.tensor([0.0], dtype=f32), b1=torch.tensor([1.0], dtype=f32),
                 k=torch.tensor([0.0], dtype=f32), mat=torch.tensor([0], dtype=i32),
                 valid=torch.tensor([False]))


def _dummy_triangles() -> Triangles:
    f32 = torch.float32
    return Triangles(
        v0=torch.tensor([[0.0, 0.0, 0.0]], dtype=f32),
        v1=torch.tensor([[1.0, 0.0, 0.0]], dtype=f32),
        v2=torch.tensor([[0.0, 1.0, 0.0]], dtype=f32),
        n0=torch.tensor([[0.0, 0.0, 1.0]], dtype=f32),
        n1=torch.tensor([[0.0, 0.0, 1.0]], dtype=f32),
        n2=torch.tensor([[0.0, 0.0, 1.0]], dtype=f32),
        uv0=torch.tensor([[0.0, 0.0]], dtype=f32),
        uv1=torch.tensor([[1.0, 0.0]], dtype=f32),
        uv2=torch.tensor([[0.0, 1.0]], dtype=f32),
        mat=torch.tensor([0], dtype=torch.int32), valid=torch.tensor([False]))


def _dummy_volumes() -> Volumes:
    f32 = torch.float32
    return Volumes(
        vtype=torch.tensor([VOL_SPHERE], dtype=torch.int32),
        center=torch.tensor([[0.0, 1e9, 0.0]], dtype=f32),
        radius=torch.tensor([1.0], dtype=f32),
        bmin=torch.tensor([[0.0, 0.0, 0.0]], dtype=f32),
        bmax=torch.tensor([[1.0, 1.0, 1.0]], dtype=f32),
        cos_t=torch.tensor([1.0], dtype=f32), sin_t=torch.tensor([0.0], dtype=f32),
        offset=torch.tensor([[0.0, 0.0, 0.0]], dtype=f32),
        neg_inv_density=torch.tensor([-1.0], dtype=f32),
        mat=torch.tensor([0], dtype=torch.int32), valid=torch.tensor([False]))
