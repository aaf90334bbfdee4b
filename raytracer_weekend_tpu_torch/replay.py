"""Packed-row path replay: the fused render's differentiable backward.

Port of `raytracer_weekend_tpu/replay.py`, sphere family. It re-traces the
paths that the fused forward recorded as per-bounce winner codes
(`ops.cuda.megakernel.render_fused(..., emit_paths=True)`), with the O(S)
closest-hit search replaced by one row lookup per bounce. Under
`torch.autograd` this function is the backward of the fused render: its
autograd is the plain version of kernel K2 (`ops/cuda/replay_bwd.py`).

Gradient semantics are the staged path's: discrete choices (winners,
hit/miss, reflect/refract) stay fixed; continuous factors (intersection t,
normals, textures, scatter math) differentiate.

The JAX package's one-hot MXU row gather (`_rows`/`_rows_mxu`, with its bf16
mantissa split) is a TPU workaround; here a row is `tab[idx]`, whose
autograd transpose is an index_add.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch import materials as mat_mod
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic
from raytracer_weekend_tpu_torch.vecmath import dot

# Family ids inside the winner codes (fam + 4*idx); 0 = miss or dead.
_C_MISS, _C_SPHERE, _C_PLANAR, _C_VOLUME = 0, 1, 2, 3


def _mat_cols(scene: SceneData, mat: torch.Tensor) -> list[torch.Tensor]:
    """Per-primitive material/texture parameter columns, each (N,1) or (N,3):
    the shared tail of every packed family table (13 columns)."""
    mt, tx = scene.materials, scene.textures
    mat = mat.long()
    tid = mt.tex[mat].long()
    return [
        mt.mtype[mat].to(torch.float32)[:, None],
        mt.fuzz[mat][:, None], mt.ior[mat][:, None],
        tx.ttype[tid].to(torch.float32)[:, None],
        tx.color1[tid], tx.color2[tid],
        tx.scale[tid][:, None],
        tx.image_id[tid].to(torch.float32)[:, None],
        tid.to(torch.float32)[:, None],
    ]


def _tail(row: torch.Tensor, s: int) -> dict:
    """Column views of the material tail that starts at column `s`."""
    return dict(
        mtype=torch.round(row[:, s + 0]).to(torch.int32),
        fuzz=row[:, s + 1], ior=row[:, s + 2],
        ttype=torch.round(row[:, s + 3]).to(torch.int32),
        c1=row[:, s + 4:s + 7], c2=row[:, s + 7:s + 10],
        scale=row[:, s + 10],
        img_id=torch.round(row[:, s + 11]).to(torch.int32),
        tid=torch.round(row[:, s + 12]).to(torch.int32),
    )


_SPH_TAIL = 8   # alpha(3) beta(3) r r2


def _pack_spheres(scene: SceneData) -> torch.Tensor:
    """(S, 8 + 13): alpha(3), beta(3), r, r2, material tail.

    The center is the affine alpha + time*beta: alpha is the center at time
    0, beta its velocity (a static sphere has beta = 0).
    """
    sp = scene.spheres
    dt = sp.t1 - sp.t0
    beta = (sp.c1 - sp.c0) / torch.where(dt == 0, 1.0, dt)[:, None]
    alpha = sp.c0 - sp.t0[:, None] * beta
    cols = [alpha, beta, sp.radius[:, None], (sp.radius ** 2)[:, None],
            *_mat_cols(scene, sp.mat)]
    return torch.cat(cols, dim=1)


def _tex_value_packed(tail: dict, p: torch.Tensor) -> torch.Tensor:
    """Texture value from packed row columns: SOLID and CHECKER.

    The JAX version also evaluates NOISE, IMAGE and UVDEBUG here (the last
    two from the hit's u, v); `replay_rays` raises for scenes that have
    them, as `textures.texture_value` does.
    """
    sines = torch.prod(torch.sin(tail["scale"][:, None] * p), dim=-1)
    odd = (tail["ttype"] == tex_mod.CHECKER) & (sines < 0.0)
    return torch.where(odd[:, None], tail["c2"], tail["c1"])


def _check_replay_scope(static: SceneStatic) -> None:
    from raytracer_weekend_tpu_torch.integrator import _check_spheres_only

    _check_spheres_only(static)
    if static.has_noise or static.has_image or static.has_uvdebug:
        raise NotImplementedError(tex_mod._NOT_PORTED)


def replay_rays(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                ray_id: torch.Tensor, seed, codes: torch.Tensor) -> torch.Tensor:
    """Differentiable radiance replay along saved winner paths -> (B,3).

    `codes` (B, max_depth) int32 are the fused forward's per-bounce winner
    records (fam + 4*idx; 0 = miss or dead). Sphere scenes with solid or
    checker textures; planar, volume, noise, image and uv-debug scenes
    raise `NotImplementedError`.
    """
    _check_replay_scope(static)
    return replay_packed(_pack_spheres(scene), scene.background, cfg, o, d,
                         time, ray_id, seed, codes)


def replay_packed(sph_tab: torch.Tensor, background: torch.Tensor,
                  cfg: RenderConfig, o: torch.Tensor, d: torch.Tensor,
                  time: torch.Tensor, ray_id: torch.Tensor, seed,
                  codes: torch.Tensor) -> torch.Tensor:
    """`replay_rays` on a packed sphere table (S, 21) -> (B,3).

    The body of the JAX `replay_rays` bounce scan, sphere arm. Gradients
    reach `sph_tab`, `background`, `o`, `d` and `time`.
    """
    B = o.shape[0]
    dev = o.device
    codes = codes.to(torch.int64)
    throughput = torch.ones((B, 3), device=dev)
    radiance = torch.zeros((B, 3), device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)

    for depth in range(cfg.max_depth):
        code = codes[:, depth]
        hit_mask = alive & (code > 0)
        is_sph = hit_mask & ((code & 3) == _C_SPHERE)
        idx = torch.where(is_sph, code >> 2, 0)

        a = dot(d, d)
        row = sph_tab[idx]                                   # (B, 21)
        alpha, beta = row[:, 0:3], row[:, 3:6]
        r, r2 = row[:, 6], row[:, 7]
        tail = _tail(row, _SPH_TAIL)
        center = alpha + time[:, None] * beta
        oc = o - center
        half_b = dot(oc, d)
        c_term = dot(oc, oc) - r2
        disc = half_b * half_b - a * c_term
        sq = torch.sqrt(torch.where(disc > 0, disc, 1.0))
        inv_a = 1.0 / a
        root1 = (-half_b - sq) * inv_a
        root2 = (-half_b + sq) * inv_a
        t_s = torch.where(root1 >= cfg.t_min, root1, root2)
        p_s = o + t_s[:, None] * d
        out_s = (p_s - center) / r[:, None]
        m = is_sph[:, None]
        p = torch.where(m, p_s, o)
        outward = torch.where(m, out_s, torch.tensor([1.0, 0.0, 0.0],
                                                     device=dev))
        mtype = torch.where(is_sph, tail["mtype"], 0)
        fuzz = torch.where(is_sph, tail["fuzz"], 0.0)
        ior = torch.where(is_sph, tail["ior"], 1.0)
        texc = torch.where(m, _tex_value_packed(tail, p_s), 1.0)

        # Shared bounce tail: the semantics of integrator.trace_lanes.
        miss = alive & ~hit_mask
        radiance = radiance + torch.where(miss[:, None],
                                          throughput * background, 0.0)
        alive = hit_mask

        front_face = dot(d, outward) < 0.0
        normal = torch.where(front_face[:, None], outward, -outward)
        sc = mat_mod.scatter_packed(mtype, fuzz, ior, texc, d, p, normal,
                                    front_face, seed, ray_id, depth)
        radiance = radiance + torch.where(alive[:, None],
                                          throughput * sc.emitted, 0.0)
        throughput = torch.where(alive[:, None],
                                 throughput * sc.attenuation, throughput)
        alive = alive & sc.alive
        o = torch.where(alive[:, None], p, o)
        d = torch.where(alive[:, None], sc.direction, d)
    return radiance
