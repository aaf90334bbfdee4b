"""Packed-row path replay: the fused render's differentiable backward.

Port of `raytracer_weekend_tpu/replay.py`: spheres, rects, triangles and
constant-density media with solid, checker, noise, image and uv-debug
textures. It re-traces the paths
that the fused forward recorded as per-bounce winner codes
(`ops.cuda.megakernel.render_fused(..., emit_paths=True)`), with the
closest-hit search replaced by one row lookup per family and bounce. Under
`torch.autograd` this function is the backward of the fused render: its
autograd is the plain version of kernels K2 and K4 (`ops/cuda/replay_bwd.py`),
its deferred form (`replay_packed(..., Texels(defer=True))`: per-bounce
contributions with noise and image texels shaded as 1.0, and the noise hit
points) that of K7, and for uv-debug and volume scenes, which those kernels
do not cover, it is the backward itself (`fused_diff.py`).

Gradient semantics are the staged path's: discrete choices (winners,
hit/miss, reflect/refract) stay fixed; continuous factors (intersection t,
normals, textures, scatter math) differentiate.

The JAX package's one-hot MXU row gather (`_rows`/`_rows_mxu`, with its bf16
mantissa split) is a TPU workaround; here a row is read as the textures'
rows are (`textures._rows`: one select per row of a table of at most 8
rows, else `index_select`), because the backward of `tab[idx]` adds every
lane's cotangent into a few rows one after another: seconds a frame on a
card for a room of 6 rects.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raytracer_weekend_tpu_torch import materials as mat_mod
from raytracer_weekend_tpu_torch import perlin
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.sphere import sphere_uv
from raytracer_weekend_tpu_torch.ops.volume import volume_candidates
from raytracer_weekend_tpu_torch.scene.data import (
    SceneData, SceneStatic, Volumes)
from raytracer_weekend_tpu_torch.vecmath import cross, dot

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
# The columns of a `_pack_planar` row, by name: the geometry and shading
# coefficients, then the material tail of `_mat_cols`. The kernels' tables
# (ops/cuda) select their rows from these by name.
PLANAR_COLS = (
    "nx", "ny", "nz", "k", "uax", "uay", "uaz", "ca", "ubx", "uby", "ubz",
    "cb", "ns0x", "ns0y", "ns0z", "nsux", "nsuy", "nsuz", "nsvx", "nsvy",
    "nsvz", "tu0", "tuu", "tuv", "tv0", "tvu", "tvv",
    "mtype", "fuzz", "ior", "ttype", "c1r", "c1g", "c1b", "c2r", "c2g", "c2b",
    "tscale", "img_id", "tid",
)
_PLA_TAIL = PLANAR_COLS.index("mtype")


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


def _pack_planar(scene: SceneData, static: SceneStatic) -> torch.Tensor:
    """(R + T, 27 + 13) unified rect + triangle rows, rects first (the
    fused kernel's planar index order): the geometry affine coefficients
    n(3) k ua(3) ca ub(3) cb, the shading interpolants ns0 nsu nsv (9), the
    texture affines tu(3) tv(3), then the material tail.

    The coefficient definitions of the JAX `_pack_planar` and of the fused
    kernel's planar table: t = (k - n.o)/(n.d), u = ua.p + ca,
    v = ub.p + cb, outward = ns0 + u*nsu + v*nsv, tex_uv = (tu|tv).(1, u, v).
    """
    parts = []
    if static.n_rects:
        rc = scene.rects
        f_ax = rc.axis.long()
        a_ax = torch.where(f_ax == 0, 1, 0)
        b_ax = torch.where(f_ax == 2, 1, 2)
        eye = torch.eye(3, dtype=torch.float32, device=f_ax.device)
        n = eye[f_ax]
        da = rc.a1 - rc.a0
        db = rc.b1 - rc.b0
        inv_da = 1.0 / torch.where(da == 0, 1.0, da)
        inv_db = 1.0 / torch.where(db == 0, 1.0, db)
        ua = eye[a_ax] * inv_da[:, None]
        ub = eye[b_ax] * inv_db[:, None]
        z = torch.zeros_like(rc.k)
        z3 = torch.zeros_like(n)
        one = torch.ones_like(rc.k)
        geom = [n, rc.k[:, None], ua, (-rc.a0 * inv_da)[:, None],
                ub, (-rc.b0 * inv_db)[:, None],
                n, z3, z3,                                    # ns0/nsu/nsv
                torch.stack([z, one, z], 1), torch.stack([z, z, one], 1)]
        parts.append(torch.cat(geom + _mat_cols(scene, rc.mat), dim=1))
    if static.n_triangles:
        tr = scene.triangles
        ab = tr.v1 - tr.v0
        ac = tr.v2 - tr.v0
        n = cross(ab, ac)
        nsq = torch.sum(n * n, dim=1)
        inv_nsq = (1.0 / torch.where(nsq == 0, 1.0, nsq))[:, None]
        ua = cross(ac, n) * inv_nsq
        ub = cross(n, ab) * inv_nsq
        uv0 = tr.uv0
        geom = [n, torch.sum(n * tr.v0, dim=1)[:, None],
                ua, -torch.sum(ua * tr.v0, dim=1)[:, None],
                ub, -torch.sum(ub * tr.v0, dim=1)[:, None],
                tr.n0, tr.n1 - tr.n0, tr.n2 - tr.n0,
                torch.stack([uv0[:, 0], (tr.uv1 - uv0)[:, 0],
                             (tr.uv2 - uv0)[:, 0]], 1),
                torch.stack([uv0[:, 1], (tr.uv1 - uv0)[:, 1],
                             (tr.uv2 - uv0)[:, 1]], 1)]
        parts.append(torch.cat(geom + _mat_cols(scene, tr.mat), dim=1))
    return torch.cat(parts, dim=0)


class Texels(NamedTuple):
    """How the replay shades noise and image texels: inline from `table`
    (the flags say which arms the scene has), or as 1.0 with `defer`."""

    table: Optional[tex_mod.TextureTable] = None
    has_noise: bool = False
    has_image: bool = False
    defer: bool = False


def _tex_value_packed(tail: dict, u: torch.Tensor, v: torch.Tensor,
                      p: torch.Tensor, tex: Texels) -> torch.Tensor:
    """Texture value from packed row columns: SOLID, CHECKER and UVDEBUG are
    column math; NOISE and IMAGE (when `tex` says the scene has them) use
    the shared texture code, or shade as 1.0 when `tex.defer`."""
    ttype = tail["ttype"]
    sines = torch.prod(torch.sin(tail["scale"][:, None] * p), dim=-1)
    odd = (ttype == tex_mod.CHECKER) & (sines < 0.0)
    out = torch.where(odd[:, None], tail["c2"], tail["c1"])
    is_noise = ttype == tex_mod.NOISE
    is_image = ttype == tex_mod.IMAGE
    if tex.defer:
        out = torch.where((is_noise | is_image)[:, None], 1.0, out)
    else:
        if tex.has_noise:
            tx = tex.table
            turb = perlin.turbulence(tx.perlin_grad, tx.perlin_perm, p,
                                     depth=7)
            marble = 0.5 * (1.0 + torch.sin(tail["scale"] * p[:, 2]
                                            + 10.0 * turb))
            out = torch.where(is_noise[:, None],
                              marble[:, None].expand_as(out), out)
        if tex.has_image:
            img = tex_mod._image_fetch(tex.table, tail["img_id"], u, v)
            out = torch.where(is_image[:, None], img, out)
    uvdbg = torch.stack([u, v, torch.zeros_like(u)], dim=-1)
    return torch.where((ttype == tex_mod.UVDEBUG)[:, None], uvdbg, out)


class Media(NamedTuple):
    """The media a replay re-samples: the volume table and each medium's
    isotropic albedo (V, 3)."""

    volumes: Volumes
    albedo: torch.Tensor


def _check_replay_scope(static: SceneStatic) -> None:
    """The scenes the fused forward records codes for."""
    if not static.fused_simple:
        raise NotImplementedError(
            f"replay needs a fused_simple scene (uv-debug on planar "
            f"primitives only): {static}")


def replay_rays(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                ray_id: torch.Tensor, seed, codes: torch.Tensor) -> torch.Tensor:
    """Differentiable radiance replay along saved winner paths -> (B,3).

    `codes` (B, max_depth) int32 are the fused forward's per-bounce winner
    records (fam + 4*idx; 0 = miss or dead). Sphere, rect, triangle and
    constant-medium scenes with solid, checker, noise, image or (planar)
    uv-debug textures, the texels evaluated inline.
    """
    _check_replay_scope(static)
    sph = _pack_spheres(scene) if static.n_spheres else None
    pla = (_pack_planar(scene, static)
           if static.n_rects or static.n_triangles else None)
    media = None
    if static.n_volumes:
        vol = scene.volumes
        tid = scene.materials.tex[vol.mat.long()].long()
        media = Media(vol, scene.textures.color1[tid])
    return replay_packed(sph, pla, scene.background, cfg, o, d, time, ray_id,
                         seed, codes,
                         Texels(scene.textures, static.has_noise,
                                static.has_image), media)


def replay_packed(sph_tab, pla_tab, background: torch.Tensor,
                  cfg: RenderConfig, o: torch.Tensor, d: torch.Tensor,
                  time: torch.Tensor, ray_id: torch.Tensor, seed,
                  codes: torch.Tensor, tex: Texels = Texels(),
                  media: Optional[Media] = None):
    """`replay_rays` on packed tables -> (B,3).

    sph_tab (S, 21) from `_pack_spheres` and pla_tab (R + T, 40) from
    `_pack_planar`, each None when its family is absent, and `media` where
    the scene has volumes. The body of the JAX `replay_rays` bounce scan.
    Gradients reach both tables, `background`, `o`, `d`, `time`, the media
    and the texture table of `tex`. A sphere's image texel reads its
    spherical UV; uv-debug textures sit on planar primitives only (the
    builder's `fused_simple`). A medium winner re-samples its candidate
    (`ops.volume.volume_candidates` of the known medium) and scatters
    isotropically over its albedo.

    With `tex.defer` it returns the deferred form instead: (ctb (B, D, 3),
    the per-bounce radiance contributions with noise and image texels
    shaded as 1.0; pn (B, D, 3), the hit point of each bounce whose winner
    has a noise texture, else 0), the pair whose vector-Jacobian product
    with the cotangents (g_k, cabc) is the deferred backward (kernel K7).
    """
    B = o.shape[0]
    dev = o.device
    codes = codes.to(torch.int64)
    throughput = torch.ones((B, 3), device=dev)
    radiance = torch.zeros((B, 3), device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    zero = torch.zeros((B,), device=dev)
    ctbs, pns = [], []

    for depth in range(cfg.max_depth):
        code = codes[:, depth]
        hit_mask = alive & (code > 0)
        fam = code & 3
        is_sph = hit_mask & (fam == _C_SPHERE)
        is_pla = hit_mask & (fam == _C_PLANAR)
        is_vol = hit_mask & (fam == _C_VOLUME)

        a = dot(d, d)
        p = o
        outward = torch.tensor([1.0, 0.0, 0.0], device=dev).expand(B, 3)
        mtype = torch.zeros((B,), dtype=torch.int32, device=dev)
        fuzz = zero
        ior = torch.ones((B,), device=dev)
        texc = torch.ones((B, 3), device=dev)
        noise_hit = torch.zeros((B,), dtype=torch.bool, device=dev)

        if sph_tab is not None:
            row = tex_mod._rows(sph_tab, torch.where(is_sph, code >> 2, 0))
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
            u_s = v_s = zero
            if tex.has_image and not tex.defer:
                u_s, v_s = sphere_uv(out_s)
            m = is_sph
            p = torch.where(m[:, None], p_s, p)
            outward = torch.where(m[:, None], out_s, outward)
            mtype = torch.where(m, tail["mtype"], mtype)
            fuzz = torch.where(m, tail["fuzz"], fuzz)
            ior = torch.where(m, tail["ior"], ior)
            texc = torch.where(m[:, None],
                               _tex_value_packed(tail, u_s, v_s, p_s, tex),
                               texc)
            noise_hit = noise_hit | (m & (tail["ttype"] == tex_mod.NOISE))

        if pla_tab is not None:
            row = tex_mod._rows(pla_tab, torch.where(is_pla, code >> 2, 0))
            n, k = row[:, 0:3], row[:, 3]
            ua, ca = row[:, 4:7], row[:, 7]
            ub, cb = row[:, 8:11], row[:, 11]
            ns0, nsu, nsv = row[:, 12:15], row[:, 15:18], row[:, 18:21]
            tu, tv = row[:, 21:24], row[:, 24:27]
            tail = _tail(row, _PLA_TAIL)
            df = -dot(d, n)
            inv_df = 1.0 / torch.where(df == 0.0, 1.0, df)
            t_p = (dot(o, n) - k) * inv_df
            p_p = o + t_p[:, None] * d
            u_b = dot(ua, p_p) + ca        # in-plane / barycentric coords
            v_b = dot(ub, p_p) + cb
            out_p = ns0 + u_b[:, None] * nsu + v_b[:, None] * nsv
            u_p = tu[:, 0] + u_b * tu[:, 1] + v_b * tu[:, 2]
            v_p = tv[:, 0] + u_b * tv[:, 1] + v_b * tv[:, 2]
            m = is_pla
            p = torch.where(m[:, None], p_p, p)
            outward = torch.where(m[:, None], out_p, outward)
            mtype = torch.where(m, tail["mtype"], mtype)
            fuzz = torch.where(m, tail["fuzz"], fuzz)
            ior = torch.where(m, tail["ior"], ior)
            texc = torch.where(m[:, None],
                               _tex_value_packed(tail, u_p, v_p, p_p, tex),
                               texc)
            noise_hit = noise_hit | (m & (tail["ttype"] == tex_mod.NOISE))

        if media is not None:
            cand = volume_candidates(
                media.volumes, o, d, cfg.t_min, seed, ray_id, depth,
                use_log10=cfg.use_log10_volume_sampling)      # (B, V)
            vidx = torch.where(is_vol, code >> 2, 0)
            t_v = torch.gather(cand, 1, vidx[:, None])[:, 0]
            t_v = torch.where(torch.isfinite(t_v), t_v, 0.0)
            m = is_vol
            p = torch.where(m[:, None], o + t_v[:, None] * d, p)
            # outward stays the (1, 0, 0) placeholder: isotropic ignores it.
            mtype = torch.where(m, mat_mod.ISOTROPIC, mtype)
            texc = torch.where(m[:, None], tex_mod._rows(media.albedo, vidx),
                               texc)

        # Shared bounce tail: the semantics of integrator.trace_lanes.
        miss = alive & ~hit_mask
        miss_c = torch.where(miss[:, None], throughput * background, 0.0)
        radiance = radiance + miss_c
        alive = hit_mask

        # A medium scatter is front-facing, as in integrator._hit_record.
        front_face = (dot(d, outward) < 0.0) | is_vol
        normal = torch.where(front_face[:, None], outward, -outward)
        sc = mat_mod.scatter_packed(mtype, fuzz, ior, texc, d, p, normal,
                                    front_face, seed, ray_id, depth)
        emit_c = torch.where(alive[:, None], throughput * sc.emitted, 0.0)
        radiance = radiance + emit_c
        if tex.defer:
            ctbs.append(miss_c + emit_c)
            pns.append(torch.where(noise_hit[:, None], p, 0.0))
        throughput = torch.where(alive[:, None],
                                 throughput * sc.attenuation, throughput)
        alive = alive & sc.alive
        o = torch.where(alive[:, None], p, o)
        d = torch.where(alive[:, None], sc.direction, d)
    if tex.defer:
        return torch.stack(ctbs, dim=1), torch.stack(pns, dim=1)
    return radiance
