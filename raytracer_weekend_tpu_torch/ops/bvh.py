"""Stackless BVH traversal (port of `ops/bvh.py`), the plain version.

The tree is the flat DFS skip-link layout `native.build_bvh` emits (one
array of nodes, `skip[i]` jumping over node i's subtree). Every ray carries
its own cursor and advances one node a step, in lockstep, as the JAX
`lax.while_loop` does:

    hit(bbox_i)?  cursor+1  (and test the primitive when i is a leaf)
               :  cursor = skip[i]

The slab test prunes against the ray's current best t, so the reference's
early tightening (t_max narrowed by the left hit) falls out. A leaf is taken
only where its t is strictly below the best so far: on an exact tie the
first leaf in DFS order keeps the lane (brute force keeps the lowest row).

`traverse` with `sphere_prim_test` / `triangle_prim_test` is the plain
version of the CUDA kernel in `ops.cuda.bvh_traverse` (csrc/bvh.cu), which
is held to it bit for bit on the card.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

_INF = math.inf


class Bvh(NamedTuple):
    """Flat DFS BVH (native/bvh_builder.cpp layout)."""

    bmin: torch.Tensor  # (M,3) f32
    bmax: torch.Tensor  # (M,3) f32
    prim: torch.Tensor  # (M,) int32  leaf: primitive row; inner: -1
    skip: torch.Tensor  # (M,) int32  next node when bbox i misses

    def to(self, device) -> "Bvh":
        return Bvh(*(t.to(device) for t in self))


def empty_bvh(device="cpu") -> Bvh:
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return Bvh(z3, z3, z, z)


def traverse(bvh: Bvh, o: torch.Tensor, d: torch.Tensor, t_min: float,
             prim_test: Callable[[torch.Tensor, torch.Tensor],
                                 tuple[torch.Tensor, torch.Tensor]]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit via skip-link traversal -> (t (B,), +inf where no leaf
    is hit; prim (B,) int32, 0 there).

    prim_test(prim_rows (B,) int64, t_max (B,)) -> (t (B,), hit (B,)) tests
    one primitive row per ray. The loop runs until every cursor has left
    the tree. A lane that has left it takes nothing more: the JAX loop
    keeps testing its clamped node M - 1 and could take that leaf, where a
    NaN slab time (o on a parent box's plane, a zero component of d) had
    made the parent miss, so its answer depended on the other lanes of the
    batch; here, as in the kernel, each lane's walk is its own.
    """
    B = o.shape[0]
    M = bvh.prim.shape[0]
    t_best = torch.full((B,), _INF, dtype=o.dtype, device=o.device)
    best_prim = torch.zeros((B,), dtype=torch.int32, device=o.device)
    if M == 0 or B == 0:
        return t_best, best_prim
    inv_d = 1.0 / d                                  # (B,3); inf on zeros
    cursor = torch.zeros((B,), dtype=torch.int64, device=o.device)
    prim_all = bvh.prim.long()
    skip_all = bvh.skip.long()
    while True:
        active = cursor < M
        if not bool(active.any()):
            break
        i = torch.clamp(cursor, max=M - 1)
        nb_min = bvh.bmin[i]                          # (B,3)
        nb_max = bvh.bmax[i]

        # Slab test against (t_min, t_best); torch.minimum/maximum propagate
        # NaN ((bmin - o) * inf with o on the plane), and the box then misses.
        t0 = (nb_min - o) * inv_d
        t1 = (nb_max - o) * inv_d
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        enter = torch.clamp(torch.amax(near, dim=-1), min=t_min)
        exit_ = torch.minimum(torch.amin(far, dim=-1), t_best)
        box_hit = enter < exit_

        prim_rows = prim_all[i]                       # (B,)
        is_leaf = prim_rows >= 0
        t_p, p_hit = prim_test(torch.clamp(prim_rows, min=0), t_best)
        take = active & box_hit & is_leaf & p_hit & (t_p < t_best)
        t_best = torch.where(take, t_p, t_best)
        best_prim = torch.where(take, prim_rows.to(torch.int32), best_prim)

        nxt = torch.where(box_hit, cursor + 1, skip_all[i])
        cursor = torch.where(active, nxt, cursor)
    return t_best, best_prim


# ---------------------------------------------------------------------------
# Per-family single-primitive tests (the leaf callbacks)
# ---------------------------------------------------------------------------

def _sum3(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] + x[..., 1] + x[..., 2], left to right (jnp.sum's order
    over a trailing axis of 3)."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b with each product and difference its own rounded operation
    (the kernel's `__fmul_rn`/`__fsub_rn`; `torch.linalg.cross` may fuse)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def triangle_edges(tr):
    """(ab, ac, n = ab x ac) of every triangle, as the leaf test computes
    them; the kernel's triangle rows hold these values."""
    ab = tr.v1 - tr.v0
    ac = tr.v2 - tr.v0
    return ab, ac, cross3(ab, ac)


def sphere_prim_test(sp, o, d, time, t_min: float):
    """Leaf callback for the sphere table: the quadratic in the oc form
    (o - c(t) first), with 1/a, as the JAX leaf test writes it (not
    `ops.sphere`'s expanded form)."""

    def test(rows: torch.Tensor, t_max: torch.Tensor):
        c0 = sp.c0[rows]
        c1 = sp.c1[rows]
        w = ((time - sp.t0[rows]) / (sp.t1[rows] - sp.t0[rows]))[:, None]
        c = c0 + w * (c1 - c0)
        r = sp.radius[rows]
        oc = o - c
        a = _sum3(d * d)
        half_b = _sum3(oc * d)
        cterm = _sum3(oc * oc) - r * r
        disc = half_b * half_b - a * cterm
        ok = disc > 0.0
        sq = torch.sqrt(torch.where(ok, disc, 1.0))
        inv_a = 1.0 / a
        root1 = (-half_b - sq) * inv_a
        root2 = (-half_b + sq) * inv_a
        r1_ok = (root1 >= t_min) & (root1 <= t_max)
        root = torch.where(r1_ok, root1, root2)
        hit = ok & (root >= t_min) & (root <= t_max) & sp.valid[rows]
        return root, hit

    return test


def triangle_prim_test(tr, o, d, t_min: float):
    """Leaf callback for the triangle table (Moller-Trumbore with the
    scalar triple products, as the JAX leaf test)."""

    def test(rows: torch.Tensor, t_max: torch.Tensor):
        v0 = tr.v0[rows]
        ab = tr.v1[rows] - v0
        ac = tr.v2[rows] - v0
        n = cross3(ab, ac)
        det = -_sum3(d * n)
        degen = det == 0.0
        inv_det = 1.0 / torch.where(degen, 1.0, det)
        ao = o - v0
        aoxd = cross3(ao, d)
        u = _sum3(ac * aoxd) * inv_det
        v = -_sum3(ab * aoxd) * inv_det
        t = _sum3(ao * n) * inv_det
        hit = ((t >= t_min) & (t <= t_max) & (t >= 0.0)
               & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & ~degen & tr.valid[rows])
        return t, hit

    return test
