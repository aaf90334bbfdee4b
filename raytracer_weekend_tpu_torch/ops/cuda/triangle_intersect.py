"""Closest triangle per ray: kernel K12, inside a torch.autograd.Function.

Counterpart of `raytracer_weekend_tpu/ops/pallas/triangle_intersect.py`.
`hit_triangles_kernel(tr, o, d, t_min, table)` returns (t (B,) f32, +inf on
a miss; idx (B,) int32, the lowest row among equal t, 0 on a miss):

  * forward: on CUDA tensors the hand-written kernel K12
    (`csrc/intersect.cu` `hit_triangles_kernel`, Moller-Trumbore in
    scalar-triple form behind a division-free prefilter) over
    `triangle_table(tr)`, which the staged path builds once per trace and
    passes in; it raises if an operand is not float32 or the launch fails.
    On CPU tensors the plain version `ops.triangle.hit_triangles`, what the
    kernel is held against on the card;
  * backward: the JAX `custom_vjp`'s: misses carry no gradient, and torch
    autograd of t = (o - v0).n / (-d.n) on the winning triangle's gathered
    vertices (`_winning_t`, det = 0 guarded) gives the cotangents of the
    triangle table's float fields, o and d.

`tri_candidate_plain` (the prefilter's bits) and `hit_triangles_twin` (the
kernel's loop order with the prefilter) are plain twins of its design, for
the CPU tests; `count_divisions` and `tri_candidate_device` probe the
kernel's own prefilter on a card. The TPU kernel's MXU pairwise products
and padded (3, T) planes are layout and are not carried over.
"""

from __future__ import annotations

import math

import torch

from raytracer_weekend_tpu_torch.ops import triangle as tri_ops
from raytracer_weekend_tpu_torch.ops.cuda.sphere_intersect import (
    _winner_vjp, kernel_order_walk)
from raytracer_weekend_tpu_torch.scene.data import Triangles
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import cross, dot

# Launches of K12 in this process; only the launch in `_launch` adds to it.
LAUNCHES = 0

# Columns of a row of the kernel's packed triangle table, 5 float4 (the
# comment at `kTriQ` in csrc/intersect.cu).
TABLE_ROWS = ("nx", "ny", "nz", "v0n", "acx", "acy", "acz", "valid",
              "acv0x", "acv0y", "acv0z", "pad", "abx", "aby", "abz", "pad",
              "abv0x", "abv0y", "abv0z", "pad")
# The kernel's rays a thread, threads a block and rows a shared tile
# (kTriRays, kTriBlock, kTriTile in csrc/intersect.cu), for the twins.
RAYS, BLOCK, TILE = 1, 128, 128
ENTRY = "rtw_hit_triangles"
# The prefilter's constants (csrc/intersect.cu tri_candidate): t's margins
# are the planar prefilter's, megakernel.CAND_LO / CAND_HI; u + v <= 1
# against |det| SUM_HI; u, v >= -|det| NEG_TOL; a pair whose |det| lies
# outside DET_RANGE passes on its signs alone; the kernel prefilters only
# for t_min in T_MIN_RANGE.
SUM_HI, NEG_TOL = 1.0 + 2.0**-18, 2.0**-100
DET_RANGE, T_MIN_RANGE = (2.0**-60, 2.0**60), (2.0**-40, 2.0**40)


def triangle_table(tr: Triangles) -> torch.Tensor:
    """(T, len(TABLE_ROWS)) packed table from the detached fields: the
    per-triangle rows of the scalar-triple form as the plain version
    computes them (`ops.triangle.triangle_terms`), and valid as 1/0."""
    with torch.no_grad():
        n, ab, ac, ac_x_v0, ab_x_v0, v0_n = tri_ops.triangle_terms(tr)
        zero = torch.zeros_like(v0_n)
        return torch.stack([*n.unbind(1), v0_n, *ac.unbind(1),
                            tr.valid.to(n.dtype), *ac_x_v0.unbind(1), zero,
                            *ab.unbind(1), zero, *ab_x_v0.unbind(1), zero],
                           dim=1).contiguous()


def ray_operands(o, d):
    """The kernel's per-ray operands: o, d and w = o x d as the plain
    version computes it."""
    o, d = o.contiguous(), d.contiguous()
    return o, d, cross(o, d)


def _launch(table, rays, t_min: float):
    """One launch of K12 on prebuilt operands -> (t, idx int32)."""
    global LAUNCHES
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    out = _build.launch_closest_hit(
        ENTRY, rays, table, table.shape[0], t_min,
        (table.shape[0], len(TABLE_ROWS)), tail=(None,))
    LAUNCHES += 1
    return out


def count_divisions(table, rays, t_min: float) -> int:
    """The pairs of one K12 launch (counting instantiation) that passed the
    prefilter and took the division. A probe; not counted in LAUNCHES."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    divides = torch.zeros((1,), dtype=torch.int64, device=table.device)
    _build.launch_closest_hit(ENTRY, rays, table, table.shape[0], t_min,
                              (table.shape[0], len(TABLE_ROWS)),
                              tail=(divides,))
    return int(divides)


def _winning_t(tr: Triangles, o, d, idx):
    """t on each lane's winning triangle (the JAX `_winning_t`)."""
    v0 = _rows(tr.v0, idx)
    n = cross(_rows(tr.v1, idx) - v0, _rows(tr.v2, idx) - v0)
    det = -dot(d, n)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    return dot(o - v0, n) * inv_det


class _HitTriangles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_min, table, o, d, *fields):
        if o.device.type == "cpu":
            with torch.no_grad():
                t, idx = tri_ops.hit_triangles(Triangles(*fields), o, d,
                                               t_min)
            idx = idx.to(torch.int32)
        elif o.device.type == "cuda":
            t, idx = _launch(table, ray_operands(o, d), t_min)
        else:
            raise NotImplementedError(f"no triangle intersection on "
                                      f"{o.device}")
        ctx.save_for_backward(t, idx, o, d, *fields)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, ct_t, _):
        t, idx, *ins = ctx.saved_tensors
        return (None, None, *_winner_vjp(ctx, ins, ct_t, t, lambda o, d, *f:
                                         _winning_t(Triangles(*f), o, d,
                                                    idx.long())))


def hit_triangles_kernel(tr: Triangles, o, d, t_min: float, table=None):
    """Closest triangle per ray -> (t (B,) f32, idx (B,) int32): K12 on a
    card over `table` (`triangle_table(tr)`, built here when None), the
    plain version on the CPU; differentiable in the triangle table's float
    fields, o and d."""
    if table is None and o.device.type == "cuda":
        table = triangle_table(tr)
    return _HitTriangles.apply(float(t_min), table, o, d, *tr)


# ---- the prefilter and plain twins of the kernel's design ---------------------

def tri_candidate_plain(det, u_num, v_num, t_num, t_min: float, best):
    """K12's division-free prefilter on float32 CPU tensors (each product
    rounded to nearest, subnormals kept: the kernel's `_rn` bits) -> bool.
    A superset of the exact test (`checks.tri_exact_accepts`) for t_min in
    T_MIN_RANGE; see `tri_candidate` in csrc/intersect.cu."""
    from raytracer_weekend_tpu_torch.ops.cuda.megakernel import (
        CAND_HI, CAND_LO)

    f32 = torch.float32
    det, u_num, v_num, t_num, best = (torch.as_tensor(x, dtype=f32) for x in
                                      (det, u_num, v_num, t_num, best))
    lo_m, hi_m, sum_m, tol, det_lo, det_hi = (
        torch.tensor(x, dtype=f32)
        for x in (CAND_LO, CAND_HI, SUM_HI, NEG_TOL, *DET_RANGE))
    tmin_lo = torch.tensor(t_min, dtype=f32) * lo_m
    best_hi = best * hi_m
    dp = det.abs()
    neg = det < 0
    tn, un, vn = (torch.where(neg, -x, x) for x in (t_num, u_num, v_num))
    neg_tol = dp * tol
    wild = (dp < det_lo) | (dp > det_hi)
    return ((tn > 0) & (dp > 0)
            & (wild | ((tn >= dp * tmin_lo) & (tn < dp * best_hi)
                       & (un >= -neg_tol) & (vn >= -neg_tol)
                       & (un + vn <= dp * sum_m))))


def hit_triangles_twin(tr: Triangles, o, d, t_min: float, rays: int = RAYS,
                       block: int = BLOCK, tile: int = TILE):
    """Plain twin of K12's design on CPU tensors -> (t (B,) f32, idx (B,)
    int32, stats): the plain version's pairwise terms (those of
    `ops.triangle.hit_triangles`), walked in the kernel's order
    (`sphere_intersect.kernel_order_walk`); an invalid row skipped; a pair
    takes the exact test only if it passes `tri_candidate_plain` against
    the ray's running best (for t_min in T_MIN_RANGE). stats: pairs, divides
    (pairs that passed the prefilter) and missed (pairs the exact test
    would have taken against the running best that the prefilter
    rejected: 0 is the design's claim, as is t, idx equal to
    `hit_triangles`' bit for bit)."""
    nrm, ab, ac, ac_x_v0, ab_x_v0, v0_n = tri_ops.triangle_terms(tr)
    w = cross(o, d)
    det = -(d @ nrm.T)
    u_num = (w @ ac.T) - (d @ ac_x_v0.T)
    v_num = -((w @ ab.T) - (d @ ab_x_v0.T))
    t_num = (o @ nrm.T) - v0_n[None, :]
    n = o.shape[0]
    pre = T_MIN_RANGE[0] <= t_min <= T_MIN_RANGE[1]
    stats = dict(pairs=0, divides=0, missed=0)

    def pair(c, best):
        if not bool(tr.valid[c]):
            return torch.zeros((n,), dtype=torch.bool), best
        stats["pairs"] += n
        degenerate = det[:, c] == 0.0
        inv_det = 1.0 / torch.where(degenerate, 1.0, det[:, c])
        u, v, t = (x[:, c] * inv_det for x in (u_num, v_num, t_num))
        hit = ((t >= t_min) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0)
               & (u + v <= 1.0) & ~degenerate)
        cand = (tri_candidate_plain(det[:, c], u_num[:, c], v_num[:, c],
                                    t_num[:, c], t_min, best) if pre
                else torch.ones((n,), dtype=torch.bool))
        stats["divides"] += int(cand.sum())
        stats["missed"] += int((hit & (t < best) & ~cand).sum())
        return hit & cand, t

    t, idx = kernel_order_walk(n, tr.v0.shape[0], rays, block, tile, pair)
    return t, idx, stats


def tri_candidate_device(det, u_num, v_num, t_num, best,
                         t_min: float) -> torch.Tensor:
    """The kernel's `tri_candidate` on CUDA float32 tensors -> (n,) bool.
    A probe of its superset property; not on the render path and not
    counted in LAUNCHES."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    cases = (det, u_num, v_num, t_num, best)
    n = det.numel()
    for x in cases:
        if (not x.is_cuda or x.dtype != torch.float32 or x.numel() != n
                or not x.is_contiguous()):
            raise ValueError("tri_candidate_device takes contiguous float32 "
                             "CUDA tensors of one length")
    out = torch.empty((n,), dtype=torch.int32, device=det.device)
    lib = _build.load_library()
    with torch.cuda.device(det.device):
        stream = torch.cuda.current_stream(det.device).cuda_stream
        err = lib.rtw_tri_candidate(*(x.data_ptr() for x in cases), n,
                                    float(t_min), out.data_ptr(), stream)
    _build.check(lib, err, "rtw_tri_candidate launch")
    return out.bool()
