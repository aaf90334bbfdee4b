"""Table-driven, branchless material scattering (port of `materials.py`).

Every BSDF's scatter direction is computed for every lane and the per-lane
result selected by material type id.

Types:
  0 LAMBERTIAN — normal + random unit vector, degenerate fix
  1 METAL      — mirror + fuzz * ball sample, absorbs below the surface
  2 DIELECTRIC — Snell + total internal reflection + Schlick reflection
  3 DIFFUSE_LIGHT — never scatters, emits its texture
  4 ISOTROPIC  — uniform ball direction, for volumes
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_weekend_tpu_torch import rng as rt_rng
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.vecmath import (
    dot, near_zero, normalize, reflect, refract)

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4


class MaterialTable(NamedTuple):
    """SoA material bank; one row per material instance."""

    mtype: torch.Tensor  # (M,)  int32
    tex: torch.Tensor    # (M,)  int32 — albedo (or emission) texture id
    fuzz: torch.Tensor   # (M,)  f32   — metal fuzz
    ior: torch.Tensor    # (M,)  f32   — dielectric index of refraction

    def to(self, device) -> "MaterialTable":
        return MaterialTable(*(t.to(device) for t in self))


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # (B,3) next ray direction (undefined where ~alive)
    attenuation: torch.Tensor  # (B,3) throughput multiplier
    emitted: torch.Tensor      # (B,3) radiance emitted at this hit
    alive: torch.Tensor        # (B,)  bool — ray continues bouncing


def scatter(materials: MaterialTable, textures: tex_mod.TextureTable,
            mat_id: torch.Tensor, ray_dir: torch.Tensor, p: torch.Tensor,
            normal: torch.Tensor, front_face: torch.Tensor, u: torch.Tensor,
            v: torch.Tensor, seed, ray_id: torch.Tensor, depth, *,
            has_noise: bool = False, has_image: bool = False,
            defer: bool = False) -> ScatterResult:
    """Shade a batch of hits: the vectorized union of all `scatter` impls.

    With `defer`, noise and image texels are shaded as 1.0 and left to the
    caller (the fused render's deferred-texture records).
    """
    mat_id = mat_id.long()
    mtype, fuzz, ior, tex_id = (tex_mod._rows(x, mat_id) for x in (
        materials.mtype, materials.fuzz, materials.ior, materials.tex))
    tex_color = tex_mod.texture_value(
        textures, tex_id, u, v, p,
        has_noise=has_noise and not defer, has_image=has_image and not defer)
    if defer:
        ttype = textures.ttype[tex_id.long()]
        deferred = (ttype == tex_mod.NOISE) | (ttype == tex_mod.IMAGE)
        tex_color = torch.where(deferred[..., None], 1.0, tex_color)
    return scatter_packed(mtype, fuzz, ior, tex_color, ray_dir, p, normal,
                          front_face, seed, ray_id, depth)


def scatter_packed(mtype: torch.Tensor, fuzz: torch.Tensor, ior: torch.Tensor,
                   tex_color: torch.Tensor, ray_dir: torch.Tensor,
                   p: torch.Tensor, normal: torch.Tensor,
                   front_face: torch.Tensor, seed, ray_id: torch.Tensor,
                   depth) -> ScatterResult:
    """The gather-free scatter core: per-lane material parameters resolved."""
    unit_in = normalize(ray_dir, eps=1e-20)

    # Lambertian.
    ul = rt_rng.rand4(seed, ray_id, depth, rt_rng.SALT_LAMBERTIAN)
    lam_dir = normal + rt_rng.unit_vector_from_uniforms(ul[..., 0], ul[..., 1])
    lam_dir = torch.where(near_zero(lam_dir)[..., None], normal, lam_dir)

    # Metal: absorbs when the fuzzed reflection points below the surface.
    um = rt_rng.rand4(seed, ray_id, depth, rt_rng.SALT_METAL)
    met_dir = reflect(unit_in, normal) + fuzz[..., None] * (
        rt_rng.in_unit_sphere_from_uniforms(um[..., 0], um[..., 1], um[..., 2]))
    met_alive = dot(met_dir, normal) > 0.0

    # Dielectric: Schlick reflectance against the draw `ud`.
    ud = rt_rng.rand4(seed, ray_id, depth, rt_rng.SALT_DIELECTRIC)[..., 0]
    ratio = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp_max(dot(-unit_in, normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 1e-12))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_theta
    omc2 = omc * omc
    reflectance = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
    reflect_choice = cannot_refract | (reflectance > ud)
    die_dir = torch.where(reflect_choice[..., None], reflect(unit_in, normal),
                          refract(unit_in, normal, ratio))

    # Isotropic.
    ui = rt_rng.rand4(seed, ray_id, depth, rt_rng.SALT_ISOTROPIC)
    iso_dir = rt_rng.in_unit_sphere_from_uniforms(ui[..., 0], ui[..., 1],
                                                  ui[..., 2])

    is_met = (mtype == METAL)[..., None]
    is_die = (mtype == DIELECTRIC)[..., None]
    is_iso = (mtype == ISOTROPIC)[..., None]
    is_light = mtype == DIFFUSE_LIGHT

    direction = torch.where(is_met, met_dir, lam_dir)
    direction = torch.where(is_die, die_dir, direction)
    direction = torch.where(is_iso, iso_dir, direction)

    zeros = torch.zeros_like(tex_color)
    attenuation = torch.where(is_die, torch.ones_like(tex_color), tex_color)
    attenuation = torch.where(is_light[..., None], zeros, attenuation)
    emitted = torch.where(is_light[..., None], tex_color, zeros)

    # Lights terminate; metal absorbs below-surface scatters.
    alive = torch.where(mtype == METAL, met_alive, ~is_light)
    return ScatterResult(direction=direction, attenuation=attenuation,
                         emitted=emitted, alive=alive)
