"""Staged closest-sphere hit and hit record (port of `ops/sphere.py`).

B rays meet S spheres at once. As in the JAX package, the pairwise ray-sphere
dots are factored into (B,3)x(3,S) matrix products:

    half_b[b,s] = d_b . (o_b - c_s(t_b)) = (o_b . d_b) - d_b . c_s(t_b)
    c_s(t)      = c0_s + w * (c1_s - c0_s),   w = (t - t0_s)/(t1_s - t0_s)
    d . c(t)    = (D C0^T) + w * (D dC^T)
    |c(t)|^2    = |c0|^2 + 2w (c0.dc) + w^2 |dc|^2

This is the plain (reference) version that the CUDA megakernel is held
against, so on a card its matrix products must run in full float32: TF32
keeps about three decimal digits and flips many hits. `hit_spheres` checks
that TF32 is off for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from raytracer_weekend_tpu_torch.scene.data import Spheres
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import dot, ray_at

_INF = math.inf
_TWO_PI = 2.0 * math.pi


def sphere_terms(sp: Spheres):
    """Per-sphere terms of the expanded quadratic -> (dc (S,3), dt, r^2,
    |c0|^2, c0.dc, |dc|^2 (S,)); the CUDA kernel K10 reads the same values
    (`ops.cuda.sphere_intersect.sphere_table`)."""
    dc = sp.c1 - sp.c0
    return (dc, sp.t1 - sp.t0, sp.radius * sp.radius, dot(sp.c0, sp.c0),
            dot(sp.c0, dc), dot(dc, dc))


def ray_terms(o: torch.Tensor, d: torch.Tensor):
    """Per-ray terms of the expanded quadratic -> (|d|^2, o.d, |o|^2)."""
    return dot(d, d), dot(o, d), dot(o, o)


def hit_spheres(sp: Spheres, o: torch.Tensor, d: torch.Tensor,
                time: torch.Tensor, t_min: float,
                t_max: float = _INF) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest sphere hit per ray -> (t (B,), +inf on miss; idx (B,) int64).

    Ties go to the first (lowest) row, as `argmin` gives them.
    """
    if o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("hit_spheres needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    dc, dt, r2, c0_sq, c0_dc, dc_sq = sphere_terms(sp)
    w = (time[:, None] - sp.t0[None, :]) / dt[None, :]   # (B,S) lerp weight

    o_c0 = o @ sp.c0.T                      # (B,S)
    o_dc = o @ dc.T
    d_c0 = d @ sp.c0.T
    d_dc = d @ dc.T

    a, o_dot_d, o_sq = (x[:, None] for x in ray_terms(o, d))   # (B,1)
    c0_sq, c0_dc, dc_sq = c0_sq[None, :], c0_dc[None, :], dc_sq[None, :]

    d_dot_c = d_c0 + w * d_dc
    o_dot_c = o_c0 + w * o_dc
    c_sq = c0_sq + 2.0 * w * c0_dc + w * w * dc_sq

    half_b = o_dot_d - d_dot_c
    c_term = o_sq - 2.0 * o_dot_c + c_sq - r2[None, :]

    disc = half_b * half_b - a * c_term
    has_roots = disc > 0.0
    sqrtd = torch.sqrt(torch.where(has_roots, disc, 1.0))

    inv_a = 1.0 / a
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    # Nearest root in range, else the far root.
    r1_ok = (root1 >= t_min) & (root1 <= t_max)
    root = torch.where(r1_ok, root1, root2)
    in_range = (root >= t_min) & (root <= t_max)

    hit = has_roots & in_range & sp.valid[None, :]
    t_all = torch.where(hit, root, _INF)   # (B,S)
    return torch.amin(t_all, dim=-1), torch.argmin(t_all, dim=-1)


def sphere_uv(outward_normal: torch.Tensor):
    """Spherical UV of a unit point; the clip keeps arccos finite."""
    theta = torch.arccos(torch.clamp(-outward_normal[..., 1],
                                     -0.9999999, 0.9999999))
    phi = torch.atan2(-outward_normal[..., 2], outward_normal[..., 0]) + math.pi
    return phi / _TWO_PI, theta / math.pi


def sphere_record(sp: Spheres, idx: torch.Tensor, o: torch.Tensor,
                  d: torch.Tensor, time: torch.Tensor, t: torch.Tensor):
    """Hit record for winning rows -> (p, outward_normal, u, v, mat).

    The outward normal is (p - c)/r: a negative radius flips it inward. The
    rows are read by `textures._rows` (on a card the backward of `tab[idx]`
    adds a frame's lanes into the few winning rows one after another).
    """
    idx = idx.long()
    c0, c1 = _rows(sp.c0, idx), _rows(sp.c1, idx)
    t0, t1, r = _rows(sp.t0, idx), _rows(sp.t1, idx), _rows(sp.radius, idx)
    w = (time - t0) / (t1 - t0)
    center = c0 + w[:, None] * (c1 - c0)
    p = ray_at(o, d, t)
    outward = (p - center) / r[:, None]
    u, v = sphere_uv(outward)
    return p, outward, u, v, _rows(sp.mat, idx)
