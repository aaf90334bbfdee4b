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
from raytracer_weekend_tpu_torch.ops.bvh import Bvh
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
    """The complete scene.

    sphere_bvh/triangle_bvh are flat skip-link trees (`ops.bvh.Bvh`) that
    the builder records when a family is large enough (`bvh="auto"`), else
    None; SceneStatic's flags say which are present.
    """

    spheres: Spheres
    rects: Rects
    triangles: Triangles
    volumes: Volumes
    materials: MaterialTable
    textures: TextureTable
    background: torch.Tensor  # (3,) miss color
    sphere_bvh: Bvh | None = None
    triangle_bvh: Bvh | None = None

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
            background=self.background.to(device),
            sphere_bvh=_bvh_to(self.sphere_bvh, device),
            triangle_bvh=_bvh_to(self.triangle_bvh, device))

    def leaves(self) -> list[torch.Tensor]:
        """Every tensor of the scene, table by table in field order.

        Then the background, then bmin, bmax, prim, skip of the sphere
        tree and of the triangle tree where present: the order of
        `jax.tree_util.tree_leaves` on the JAX package's SceneData (its None
        BVH slots have no leaves), so gradient lists of the two packages
        line up leaf by leaf. A fit's Adam step sees the trees' float leaves
        and gives them no gradient: a fit that moves geometry leaves the
        tree stale, as in the JAX package.
        """
        out = []
        for table in self[:_N_TABLES]:
            out.extend(table)
        out.append(self.background)
        for tree in (self.sphere_bvh, self.triangle_bvh):
            if tree is not None:
                out.extend(tree)
        return out

    @property
    def trees(self) -> tuple[bool, bool]:
        """(has a sphere tree, has a triangle tree): the tree layout that
        `from_leaves` needs to read `leaves()` back."""
        return self.sphere_bvh is not None, self.triangle_bvh is not None

    @classmethod
    def from_leaves(cls, leaves, trees: tuple[bool, bool] = (False, False)
                    ) -> "SceneData":
        """Inverse of `leaves`; `trees` is the scene's `trees` (none by
        default). Raises if the leaves past the background do not make
        those trees."""
        it = iter(leaves)
        tables = [typ(*(next(it) for _ in typ._fields)) for typ in _TABLE_TYPES]
        background = next(it)
        rest = list(it)
        n_tree = len(Bvh._fields)
        if n_tree * sum(trees) != len(rest):
            raise ValueError(f"{len(rest)} leaves past the background for "
                             f"the trees {tuple(trees)}")
        made = iter([Bvh(*rest[i:i + n_tree])
                     for i in range(0, len(rest), n_tree)])
        return cls(*tables, background=background,
                   sphere_bvh=next(made) if trees[0] else None,
                   triangle_bvh=next(made) if trees[1] else None)


def without_trees(scene: SceneData, static: "SceneStatic"
                  ) -> tuple[SceneData, "SceneStatic"]:
    """The scene and its static facts without their trees: the staged path
    then tests every row (K10-K12 or the plain brute force)."""
    return (scene._replace(sphere_bvh=None, triangle_bvh=None),
            dataclasses.replace(static, sphere_bvh=False, triangle_bvh=False))


def _bvh_to(tree, device):
    return None if tree is None else tree.to(device)


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
