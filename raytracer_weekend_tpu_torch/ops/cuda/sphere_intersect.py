"""Closest moving sphere per ray: kernel K10, inside a torch.autograd.Function.

Counterpart of `raytracer_weekend_tpu/ops/pallas/sphere_intersect.py`.
`hit_spheres_kernel(sp, o, d, time, t_min, table)` returns (t (B,) f32,
+inf on a miss; idx (B,) int32, the lowest row among equal t, 0 on a miss):

  * forward: on CUDA tensors the hand-written kernel K10
    (`csrc/intersect.cu` `hit_spheres_kernel`, built at first use by
    `_build.py`) over `sphere_table(sp)`, which the staged path builds once
    per trace and passes in (`integrator.kernel_tables`); it raises if an
    operand is not float32 or the launch fails. On CPU tensors the plain
    version `ops.sphere.hit_spheres`, what the kernel is held against on
    the card (the counterpart of Pallas interpret mode);
  * backward: the JAX `custom_vjp`'s. Misses carry no gradient; every other
    lane re-derives its accepted root on the winning sphere's gathered row
    in the direct form o - c(t) (`_winning_root`), and torch autograd of that
    one-row recompute gives the cotangents of the sphere table's float
    fields, o, d and time. idx and the kernel's table get none.

`hit_spheres_twin` and `kernel_order_walk` are the plain twins of the
kernel's design (its loop order, R rays a thread, the roots only where
disc > 0), for the CPU tests. The TPU kernel's MXU pairwise dots, (3, TB) ray planes
and padded tables are layout and are not carried over.
"""

from __future__ import annotations

import math

import torch

from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops
from raytracer_weekend_tpu_torch.scene.data import Spheres
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import dot

# Launches of K10 in this process; only the launch in `_launch` adds to it.
LAUNCHES = 0

# Columns of a row of the kernel's packed sphere table, 4 float4 (the
# comment at `kSphereQ` in csrc/intersect.cu).
TABLE_ROWS = ("c0x", "c0y", "c0z", "c0_sq", "r2", "valid", "t0", "dt",
              "dcx", "dcy", "dcz", "c0_dc", "dc_sq", "pad", "pad", "pad")
# The kernel's rays a thread, threads a block and rows a shared tile
# (kSphRays, kSphBlock, kSphTile in csrc/intersect.cu), for the twins.
RAYS, BLOCK, TILE = 2, 64, 64
ENTRY = "rtw_hit_spheres"


def sphere_table(sp: Spheres) -> torch.Tensor:
    """(S, len(TABLE_ROWS)) packed table from the detached fields: the
    per-sphere terms of the expanded quadratic as the plain version computes
    them (`ops.sphere.sphere_terms`), and valid as 1/0."""
    with torch.no_grad():
        dc, dt, r2, c0_sq, c0_dc, dc_sq = sphere_ops.sphere_terms(sp)
        zero = torch.zeros_like(r2)
        return torch.stack([*sp.c0.unbind(1), c0_sq, r2,
                            sp.valid.to(r2.dtype), sp.t0, dt,
                            *dc.unbind(1), c0_dc, dc_sq, zero, zero, zero],
                           dim=1).contiguous()


def ray_operands(o, d, time):
    """The kernel's per-ray operands: o, d, time and (|d|^2, o.d, |o|^2)
    as the plain version computes them (`ops.sphere.ray_terms`)."""
    o, d, time = o.contiguous(), d.contiguous(), time.contiguous()
    return o, d, time, torch.stack(sphere_ops.ray_terms(o, d), dim=1)


def _launch(table, rays, t_min: float):
    """One launch of K10 on prebuilt operands -> (t, idx int32)."""
    global LAUNCHES
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    out = _build.launch_closest_hit(
        ENTRY, rays, table, table.shape[0], t_min,
        (table.shape[0], len(TABLE_ROWS)))
    LAUNCHES += 1
    return out


def _winning_root(sp: Spheres, o, d, time, idx, t_min: float):
    """The accepted root on each lane's winning sphere, in the direct form
    (the JAX `_winning_root`); the rows are read by `textures._rows`, whose
    backward is a sum per row for a small table."""
    c0, c1 = _rows(sp.c0, idx), _rows(sp.c1, idx)
    t0, t1, r = _rows(sp.t0, idx), _rows(sp.t1, idx), _rows(sp.radius, idx)
    w = ((time - t0) / (t1 - t0))[:, None]
    oc = o - (c0 + w * (c1 - c0))
    a = dot(d, d)
    half_b = dot(oc, d)
    c_term = dot(oc, oc) - r * r
    disc = half_b * half_b - a * c_term
    sqrtd = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    return torch.where(root1 >= t_min, root1, root2)


class _HitSpheres(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_min, table, o, d, time, *fields):
        if o.device.type == "cpu":
            with torch.no_grad():
                t, idx = sphere_ops.hit_spheres(Spheres(*fields), o, d, time,
                                                t_min)
            idx = idx.to(torch.int32)
        elif o.device.type == "cuda":
            t, idx = _launch(table, ray_operands(o, d, time), t_min)
        else:
            raise NotImplementedError(f"no sphere intersection on {o.device}")
        ctx.t_min = t_min
        ctx.save_for_backward(t, idx, o, d, time, *fields)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, ct_t, _):
        t, idx, *ins = ctx.saved_tensors
        return (None, None, *_winner_vjp(
            ctx, ins, ct_t, t, lambda o, d, time, *f: _winning_root(
                Spheres(*f), o, d, time, idx.long(), ctx.t_min)))


def _winner_vjp(ctx, ins, ct_t, t, recompute):
    """Cotangents of `ins` (the Function's inputs after t_min and the
    kernel's table) through the one-row recompute of the winner's t, misses
    zeroed (the JAX `_bwd`)."""
    wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
    ct = torch.where(torch.isfinite(t), ct_t, 0.0)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(i in wanted)
                  for i, x in enumerate(ins)]
        out = recompute(*leaves)
        grads = torch.autograd.grad(out, [leaves[i] for i in wanted], ct,
                                    allow_unused=True)
    result = [None] * len(ins)
    for i, g in zip(wanted, grads):
        result[i] = torch.zeros_like(ins[i]) if g is None else g
    return result


def hit_spheres_kernel(sp: Spheres, o, d, time, t_min: float, table=None):
    """Closest sphere per ray -> (t (B,) f32, idx (B,) int32): K10 on a
    card over `table` (`sphere_table(sp)`, built here when None), the plain
    version on the CPU; differentiable in the sphere table's float fields,
    o, d and time."""
    if table is None and o.device.type == "cuda":
        table = sphere_table(sp)
    return _HitSpheres.apply(float(t_min), table, o, d, time, *sp)


# ---- plain twins of the kernel's design, for the CPU tests --------------------

def thread_slots(n: int, rays: int, block: int) -> torch.Tensor:
    """How K10 and K12 deal n rays to threads -> slot (n,) int64: ray
    i = b * block * rays + r * block + j is slot r of thread b * block + j."""
    return (torch.arange(n) % (rays * block)) // block


def kernel_order_walk(n: int, P: int, rays: int, block: int, tile: int,
                      pair) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K10-K12's loop order -> (best (n,) f32, +inf for
    none; idx (n,) int32): each thread walks the table's P rows tile by tile
    (`tile` rows) and, for every row, its rays slot by slot
    (`thread_slots`), and a ray takes a row whose t is strictly below its
    running best. `pair(c, best)` is the kernel's arithmetic for every ray
    against row c given its best so far -> (accepted (n,) bool, t (n,))."""
    slot = thread_slots(n, rays, block)
    slots = [torch.nonzero(slot == r)[:, 0] for r in range(rays)]
    best = torch.full((n,), math.inf, dtype=torch.float32)
    idx = torch.zeros((n,), dtype=torch.int32)
    for base in range(0, P, tile):
        for c in range(base, min(P, base + tile)):
            acc, t = pair(c, best)
            for m in slots:
                take = acc[m] & (t[m] < best[m])
                best[m] = torch.where(take, t[m], best[m])
                idx[m] = torch.where(take, c, idx[m])
    return best, idx


def hit_spheres_twin(sp: Spheres, o, d, time, t_min: float, rays: int = RAYS,
                     block: int = BLOCK, tile: int = TILE):
    """Plain twin of K10's design on CPU tensors -> (t (B,) f32, idx (B,)
    int32): the plain version's pairwise terms (those of
    `ops.sphere.hit_spheres`), walked in the kernel's order
    (`kernel_order_walk`): an invalid row skipped; the square root and the
    roots only where disc > 0. The design's claim is that this is
    `ops.sphere.hit_spheres` bit for bit."""
    dc, dt, r2, c0_sq, c0_dc, dc_sq = sphere_ops.sphere_terms(sp)
    o_c0, o_dc = o @ sp.c0.T, o @ dc.T
    d_c0, d_dc = d @ sp.c0.T, d @ dc.T
    a, od, oo = sphere_ops.ray_terms(o, d)
    inv_a = 1.0 / a
    n = o.shape[0]

    def pair(c, best):
        if not bool(sp.valid[c]):
            return torch.zeros((n,), dtype=torch.bool), best
        w = (time - sp.t0[c]) / dt[c]
        d_dot_c = d_c0[:, c] + w * d_dc[:, c]
        o_dot_c = o_c0[:, c] + w * o_dc[:, c]
        c_sq = c0_sq[c] + 2.0 * w * c0_dc[c] + w * w * dc_sq[c]
        half_b = od - d_dot_c
        c_term = oo - 2.0 * o_dot_c + c_sq - r2[c]
        disc = half_b * half_b - a * c_term
        has = disc > 0.0
        root = torch.full((n,), math.nan)
        sqrtd = torch.sqrt(disc[has])
        root1 = (-half_b[has] - sqrtd) * inv_a[has]
        root2 = (-half_b[has] + sqrtd) * inv_a[has]
        root[has] = torch.where(root1 >= t_min, root1, root2)
        return has & (root >= t_min), root

    return kernel_order_walk(n, sp.c0.shape[0], rays, block, tile, pair)
