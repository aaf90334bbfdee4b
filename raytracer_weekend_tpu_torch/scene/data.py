"""Scene representation: SoA primitive tables (port of `scene/data.py`).

A scene is a set of flat tensors, one SoA table per primitive family, plus
material and texture tables. Every table is a NamedTuple of tensors with a
`.to(device)` method. Families a scene does not use carry one dummy row
with `valid=False`, as the JAX builder emits them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracer_weekend_tpu_torch.materials import MaterialTable
from raytracer_weekend_tpu_torch.textures import TextureTable

# Volume boundary types
VOL_SPHERE = 0
VOL_BOX = 1


def _to(self, device):
    """`.to(device)` for NamedTuples whose fields are all tensors."""
    return type(self)(*(t.to(device) for t in self))


class Spheres(NamedTuple):
    """Static + moving spheres in one table.

    A static sphere stores c1 == c0 with (t0, t1) = (0, 1). Negative radii
    flip the outward normal (the reference's hollow-glass trick).
    """

    c0: torch.Tensor      # (S,3) center at t0
    c1: torch.Tensor      # (S,3) center at t1
    t0: torch.Tensor      # (S,)
    t1: torch.Tensor      # (S,)
    radius: torch.Tensor  # (S,)
    mat: torch.Tensor     # (S,) int32
    valid: torch.Tensor   # (S,) bool — False for padding rows

    to = _to


class Rects(NamedTuple):
    """Axis-aligned rectangles; `axis` is the fixed-coordinate axis."""

    axis: torch.Tensor  # (R,) int32
    a0: torch.Tensor    # (R,)
    a1: torch.Tensor    # (R,)
    b0: torch.Tensor    # (R,)
    b1: torch.Tensor    # (R,)
    k: torch.Tensor     # (R,)
    mat: torch.Tensor   # (R,) int32
    valid: torch.Tensor # (R,) bool

    to = _to


class Triangles(NamedTuple):
    """Triangles with per-vertex normals and UVs."""

    v0: torch.Tensor   # (T,3)
    v1: torch.Tensor   # (T,3)
    v2: torch.Tensor   # (T,3)
    n0: torch.Tensor   # (T,3)
    n1: torch.Tensor   # (T,3)
    n2: torch.Tensor   # (T,3)
    uv0: torch.Tensor  # (T,2)
    uv1: torch.Tensor  # (T,2)
    uv2: torch.Tensor  # (T,2)
    mat: torch.Tensor  # (T,) int32
    valid: torch.Tensor  # (T,) bool

    to = _to


class Volumes(NamedTuple):
    """Constant-density participating media (sphere or oriented box)."""

    vtype: torch.Tensor   # (V,) int32 — VOL_SPHERE / VOL_BOX
    center: torch.Tensor  # (V,3)
    radius: torch.Tensor  # (V,)
    bmin: torch.Tensor    # (V,3) box min (object space)
    bmax: torch.Tensor    # (V,3) box max (object space)
    cos_t: torch.Tensor   # (V,)  Y-rotation cos
    sin_t: torch.Tensor   # (V,)  Y-rotation sin
    offset: torch.Tensor  # (V,3) translation
    neg_inv_density: torch.Tensor  # (V,) = -1/density
    mat: torch.Tensor     # (V,) int32 — isotropic phase material
    valid: torch.Tensor   # (V,) bool

    to = _to


class SceneData(NamedTuple):
    """The complete scene. The BVH slots stay None until BVHs are ported."""

    spheres: Spheres
    rects: Rects
    triangles: Triangles
    volumes: Volumes
    materials: MaterialTable
    textures: TextureTable
    background: torch.Tensor  # (3,) miss color
    sphere_bvh: object = None
    triangle_bvh: object = None

    @property
    def device(self) -> torch.device:
        return self.spheres.c0.device

    def to(self, device) -> "SceneData":
        return self._replace(
            spheres=self.spheres.to(device), rects=self.rects.to(device),
            triangles=self.triangles.to(device),
            volumes=self.volumes.to(device),
            materials=self.materials.to(device),
            textures=self.textures.to(device),
            background=self.background.to(device))

    def leaves(self) -> list[torch.Tensor]:
        """Every tensor of the scene, table by table in field order.

        The order of `jax.tree_util.tree_leaves` on the JAX package's
        SceneData (its None BVH slots have no leaves), so gradient lists of
        the two packages line up leaf by leaf.
        """
        if self.sphere_bvh is not None or self.triangle_bvh is not None:
            raise NotImplementedError("BVHs are not ported yet")
        out = []
        for table in self[:_N_TABLES]:
            out.extend(table)
        out.append(self.background)
        return out

    @classmethod
    def from_leaves(cls, leaves) -> "SceneData":
        """Inverse of `leaves`."""
        it = iter(leaves)
        tables = [typ(*(next(it) for _ in typ._fields)) for typ in _TABLE_TYPES]
        scene = cls(*tables, background=next(it))
        if next(it, None) is not None:
            raise ValueError("more leaves than a SceneData holds")
        return scene


_TABLE_TYPES = (Spheres, Rects, Triangles, Volumes, MaterialTable, TextureTable)
_N_TABLES = len(_TABLE_TYPES)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Static facts about a scene that select code paths.

    Field for field the JAX package's `SceneStatic`.
    """

    n_spheres: int
    n_rects: int
    n_triangles: int
    n_volumes: int
    has_noise: bool
    has_image: bool
    has_uvdebug: bool = False
    defer_single_hit: bool = False
    sphere_bvh: bool = False
    triangle_bvh: bool = False
    # Spheres/rects/triangles with Lambertian/Metal/Dielectric/DiffuseLight
    # materials (the JAX fused megakernel's eligibility flag).
    fused_simple: bool = False
