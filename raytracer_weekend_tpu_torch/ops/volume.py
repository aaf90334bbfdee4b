"""Constant-density media: the probabilistic "hit" (port of `ops/volume.py`).

For the convex boundaries the catalog uses (spheres and cuboids, optionally
Y-rotated and translated), the boundary's entry and exit are the two
quadratic roots or the slab test's [enter, exit] interval, computed in
closed form for B rays x V volumes at once in each volume's object frame.
The scatter distance is sampled per (ray, volume) from the counter-based
uniform,

    hit_distance = -1/density * log10(U),

the reference's log10 where the standard sampler uses ln, kept behind
`use_log10` for parity. The candidates compete in the closest-hit min like
any other family. This is the plain version that the fused kernel's volume
branch (K5, `csrc/megakernel.cuh`) is held against.
"""

from __future__ import annotations

import math

import torch

from raytracer_weekend_tpu_torch import rng as rt_rng
from raytracer_weekend_tpu_torch.scene.data import VOL_BOX, Volumes
from raytracer_weekend_tpu_torch.vecmath import dot, ray_at

_INF = math.inf
LN10_INV = 0.43429448190325176  # log10(x) = ln(x) / ln(10)


def _object_space_rays(vol: Volumes, o: torch.Tensor, d: torch.Tensor):
    """Rays in each volume's object frame -> (B, V, 3) origins, directions."""
    ot = o[:, None, :] - vol.offset[None, :, :]          # translate in
    c = vol.cos_t[None, :]
    s = vol.sin_t[None, :]
    ox = c * ot[..., 0] - s * ot[..., 2]
    oz = s * ot[..., 0] + c * ot[..., 2]
    dx = c * d[:, None, 0] - s * d[:, None, 2]
    dz = s * d[:, None, 0] + c * d[:, None, 2]
    o_obj = torch.stack([ox, ot[..., 1], oz], dim=-1)
    d_obj = torch.stack([dx, d[:, None, 1].expand_as(dx), dz], dim=-1)
    return o_obj, d_obj


def _boundary_interval(vol: Volumes, o_obj: torch.Tensor,
                       d_obj: torch.Tensor):
    """[enter, exit] of each ray with each boundary -> (B, V) each, and the
    (B, V) mask of rays that meet it. NaN (0 * inf in a slab parallel to a
    ray) propagates through min/max and compares false.

    A ray parallel to a slab (a direction component exactly 0, which a
    Lambertian bounce off an axis-aligned wall draws now and then) gets
    that slab's t = (b - o)/0 = +-inf as a constant: the same values, but
    no 0 * inf in the autograd of 1/d, and pairwise max/min instead of
    amax/amin, whose backward divides by the count of maxima (0 at NaN)."""
    oc = o_obj - vol.center[None, :, :]
    a = torch.sum(d_obj * d_obj, dim=-1)
    half_b = torch.sum(oc * d_obj, dim=-1)
    c_term = torch.sum(oc * oc, dim=-1) - (vol.radius ** 2)[None, :]
    disc = half_b * half_b - a * c_term
    sph_ok = disc > 0.0
    sqrtd = torch.sqrt(torch.where(sph_ok, disc, 1.0))
    inv_a = 1.0 / a
    sph_enter = (-half_b - sqrtd) * inv_a
    sph_exit = (-half_b + sqrtd) * inv_a

    parallel = d_obj == 0.0
    inv_d = 1.0 / torch.where(parallel, 1.0, d_obj)

    def slab(b):
        off = b[None, :, :] - o_obj
        return torch.where(parallel, (off / d_obj).detach(), off * inv_d)

    t0, t1 = slab(vol.bmin), slab(vol.bmax)
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    box_enter = torch.maximum(torch.maximum(near[..., 0], near[..., 1]),
                              near[..., 2])
    box_exit = torch.minimum(torch.minimum(far[..., 0], far[..., 1]),
                             far[..., 2])
    box_ok = box_enter < box_exit

    is_box = (vol.vtype == VOL_BOX)[None, :]
    enter = torch.where(is_box, box_enter, sph_enter)
    exit_ = torch.where(is_box, box_exit, sph_exit)
    ok = torch.where(is_box, box_ok, sph_ok)
    return enter, exit_, ok


def volume_candidates(vol: Volumes, o: torch.Tensor, d: torch.Tensor,
                      t_min: float, seed, ray_id: torch.Tensor, depth, *,
                      use_log10: bool = True) -> torch.Tensor:
    """Per-(ray, volume) scatter-distance candidates -> (B, V) t, +inf where
    the ray does not scatter in that volume. `d` need not be unit length
    (an isotropic scatter's is not): t is in units of |d|.

    The whole candidate plane also serves the replay, which needs the
    candidate of a known winner rather than the min.
    """
    o_obj, d_obj = _object_space_rays(vol, o, d)
    enter, exit_, ok = _boundary_interval(vol, o_obj, d_obj)

    # Clamp the entry to the search window and drop empty spans.
    t1c = torch.maximum(enter, torch.tensor(t_min, dtype=enter.dtype,
                                            device=enter.device))
    ok = ok & (t1c < exit_) & vol.valid[None, :]
    t1c = torch.clamp_min(t1c, 0.0)

    ray_len = torch.sqrt(dot(d, d))[:, None]                 # (B, 1)
    dist_inside = (exit_ - t1c) * ray_len

    n_vol = vol.vtype.shape[0]
    salts = rt_rng.SALT_VOLUME + torch.arange(n_vol, dtype=torch.int64,
                                              device=o.device)
    u = rt_rng.rand4(seed, ray_id[:, None], depth, salts[None, :])[..., 0]
    u = torch.clamp(u, 1e-12, 1.0)
    log_u = torch.log(u) * (LN10_INV if use_log10 else 1.0)
    hit_distance = vol.neg_inv_density[None, :] * log_u

    hit = ok & (hit_distance <= dist_inside)
    return torch.where(hit, t1c + hit_distance / ray_len, _INF)


def hit_volumes(vol: Volumes, o: torch.Tensor, d: torch.Tensor, t_min: float,
                seed, ray_id: torch.Tensor, depth, *,
                use_log10: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest medium scatter per ray -> (t (B,), +inf for none; idx (B,)
    int64, the first volume on a tie)."""
    t = volume_candidates(vol, o, d, t_min, seed, ray_id, depth,
                          use_log10=use_log10)
    return torch.amin(t, dim=-1), torch.argmin(t, dim=-1)


def volume_record(vol: Volumes, idx: torch.Tensor, o: torch.Tensor,
                  d: torch.Tensor, t: torch.Tensor):
    """Hit record of a medium scatter -> (p, outward, u, v, mat): a fixed
    normal (1, 0, 0) and UV (0, 0); the isotropic phase reads neither."""
    p = ray_at(o, d, t)
    outward = torch.zeros_like(p)
    outward[..., 0] = 1.0
    u = torch.zeros_like(t)
    return p, outward, u, u.clone(), vol.mat[idx.long()]
