"""Staged closest triangle hit and hit record (port of `ops/triangle.py`).

Möller–Trumbore, per ray and triangle (ao = o - v0, n = (v1-v0) x (v2-v0)):

    det   = -d . n
    u*det =  ac . (ao x d)
    v*det = -ab . (ao x d)
    t*det =  ao . n

As in the JAX package the pairwise cross products are expanded with the
scalar-triple identity x.(y x d) = d.(x x y), so with w = o x d per ray and
per-triangle rows {n, ab, ac, ac x v0, ab x v0, v0.n} every pairwise term is
a (B,3)x(3,T) matrix product. This is the plain version that the CUDA
megakernel's planar branch is held against, so on a card its products must
run in full float32 (TF32 flips hits): `hit_triangles` checks that TF32 is
off for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from raytracer_weekend_tpu_torch.scene.data import Triangles
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import cross, dot, ray_at

_INF = math.inf


def triangle_terms(tr: Triangles):
    """Per-triangle rows of the scalar-triple form -> (n, ab, ac, ac x v0,
    ab x v0 (T,3), v0.n (T,)); the CUDA kernel K12 reads the same values
    (`ops.cuda.triangle_intersect.triangle_table`)."""
    ab = tr.v1 - tr.v0
    ac = tr.v2 - tr.v0
    n = cross(ab, ac)                       # unnormalized face normal
    return n, ab, ac, cross(ac, tr.v0), cross(ab, tr.v0), dot(tr.v0, n)


def hit_triangles(tr: Triangles, o: torch.Tensor, d: torch.Tensor,
                  t_min: float,
                  t_max: float = _INF) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest triangle hit per ray -> (t (B,), +inf on miss; idx (B,) int64).

    Ties go to the first (lowest) row, as `argmin` gives them.
    """
    if o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("hit_triangles needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n, ab, ac, ac_x_v0, ab_x_v0, v0_n = triangle_terms(tr)

    w = cross(o, d)                         # (B,3)
    det = -(d @ n.T)                        # (B,T)
    u_num = (w @ ac.T) - (d @ ac_x_v0.T)
    v_num = -((w @ ab.T) - (d @ ab_x_v0.T))
    t_num = (o @ n.T) - v0_n[None, :]

    # det == 0: a parallel ray; the guard keeps the division finite and
    # the lane is masked off.
    degenerate = det == 0.0
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det

    hit = ((t >= t_min) & (t <= t_max) & (t >= 0.0)
           & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & ~degenerate & tr.valid[None, :])
    t_all = torch.where(hit, t, _INF)
    return torch.amin(t_all, dim=-1), torch.argmin(t_all, dim=-1)


def triangle_record(tr: Triangles, idx: torch.Tensor, o: torch.Tensor,
                    d: torch.Tensor, t: torch.Tensor):
    """Hit record for winning rows -> (p, outward_normal, u, v, mat).

    (u, v) are recomputed for the one winning triangle per ray; the normal
    and UV are barycentric mixes of the vertex values. The normal is NOT
    normalized (a raw mix of vertex normals; face normals are raw cross
    products), as in the JAX package. Rows are read by `textures._rows`.
    """
    idx = idx.long()
    v0, v1, v2 = (_rows(x, idx) for x in (tr.v0, tr.v1, tr.v2))
    ab = v1 - v0
    ac = v2 - v0
    n = cross(ab, ac)
    det = -dot(d, n)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    ao_x_d = cross(o - v0, d)
    u = dot(ac, ao_x_d) * inv_det
    v = -dot(ab, ao_x_d) * inv_det

    w0 = (1.0 - u - v)[:, None]
    wu, wv = u[:, None], v[:, None]
    n0, n1, n2, uv0, uv1, uv2 = (_rows(x, idx) for x in (
        tr.n0, tr.n1, tr.n2, tr.uv0, tr.uv1, tr.uv2))
    normal = w0 * n0 + wu * n1 + wv * n2
    uv = w0 * uv0 + wu * uv1 + wv * uv2
    p = ray_at(o, d, t)
    return p, normal, uv[..., 0], uv[..., 1], _rows(tr.mat, idx)
