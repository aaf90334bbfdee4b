"""Closest triangle per ray: kernel K12, inside a torch.autograd.Function.

Counterpart of `raytracer_weekend_tpu/ops/pallas/triangle_intersect.py`.
`hit_triangles_kernel(tr, o, d, t_min)` returns (t (B,) f32, +inf on a
miss; idx (B,) int32, the lowest row among equal t, 0 on a miss):

  * forward: on CUDA tensors the hand-written kernel K12
    (`csrc/intersect.cu` `hit_triangles_kernel`, Moller-Trumbore in
    scalar-triple form), which raises if an operand is not float32 or the
    launch fails; on CPU tensors the plain version
    `ops.triangle.hit_triangles`, what the kernel is held against on the
    card;
  * backward: the JAX `custom_vjp`'s: misses carry no gradient, and torch
    autograd of t = (o - v0).n / (-d.n) on the winning triangle's gathered
    vertices (`_winning_t`, det = 0 guarded) gives the cotangents of the
    triangle table's float fields, o and d.

The TPU kernel's MXU pairwise products and padded (3, T) planes are layout
and are not carried over.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch.ops import triangle as tri_ops
from raytracer_weekend_tpu_torch.ops.cuda.sphere_intersect import _winner_vjp
from raytracer_weekend_tpu_torch.scene.data import Triangles
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import cross, dot

# Launches of K12 in this process; only the launch in `_launch` adds to it.
LAUNCHES = 0

# Rows of the kernel's triangle table, in the order of `enum TRow` in
# csrc/intersect.cu.
TABLE_ROWS = ("nx", "ny", "nz", "abx", "aby", "abz", "acx", "acy", "acz",
              "acv0x", "acv0y", "acv0z", "abv0x", "abv0y", "abv0z", "v0n",
              "valid")


def triangle_table(tr: Triangles) -> torch.Tensor:
    """(len(TABLE_ROWS), T) table: the per-triangle rows of the scalar-triple
    form as the plain version computes them (`ops.triangle.triangle_terms`),
    and valid as 1/0."""
    n, ab, ac, ac_x_v0, ab_x_v0, v0_n = tri_ops.triangle_terms(tr)
    return torch.stack([*n.unbind(1), *ab.unbind(1), *ac.unbind(1),
                        *ac_x_v0.unbind(1), *ab_x_v0.unbind(1), v0_n,
                        tr.valid.to(n.dtype)]).contiguous()


def _launch(tr: Triangles, o, d, t_min: float):
    """One launch of K12 -> (t, idx int32)."""
    global LAUNCHES
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    o, d = o.contiguous(), d.contiguous()
    out = _build.launch_closest_hit("rtw_hit_triangles", (o, d, cross(o, d)),
                                    triangle_table(tr), t_min)
    LAUNCHES += 1
    return out


def _winning_t(tr: Triangles, o, d, idx):
    """t on each lane's winning triangle (the JAX `_winning_t`)."""
    v0 = _rows(tr.v0, idx)
    n = cross(_rows(tr.v1, idx) - v0, _rows(tr.v2, idx) - v0)
    det = -dot(d, n)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    return dot(o - v0, n) * inv_det


class _HitTriangles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_min, o, d, *fields):
        tr = Triangles(*fields)
        if o.device.type == "cpu":
            with torch.no_grad():
                t, idx = tri_ops.hit_triangles(tr, o, d, t_min)
            idx = idx.to(torch.int32)
        elif o.device.type == "cuda":
            t, idx = _launch(tr, o, d, t_min)
        else:
            raise NotImplementedError(f"no triangle intersection on "
                                      f"{o.device}")
        ctx.save_for_backward(t, idx, o, d, *fields)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, ct_t, _):
        t, idx, *ins = ctx.saved_tensors
        return (None, *_winner_vjp(ctx, ins, ct_t, t, lambda o, d, *f:
                                   _winning_t(Triangles(*f), o, d,
                                              idx.long())))


def hit_triangles_kernel(tr: Triangles, o, d, t_min: float):
    """Closest triangle per ray -> (t (B,) f32, idx (B,) int32): K12 on a
    card, the plain version on the CPU; differentiable in the triangle
    table's float fields, o and d."""
    return _HitTriangles.apply(float(t_min), o, d, *tr)
