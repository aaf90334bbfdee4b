"""Closest axis-aligned rect per ray: kernel K11, inside a torch.autograd.Function.

Counterpart of `raytracer_weekend_tpu/ops/pallas/rect_intersect.py`.
`hit_rects_kernel(rc, o, d, t_min, table)` returns (t (B,) f32, +inf on a
miss; idx (B,) int32, the lowest row among equal t, 0 on a miss):

  * forward: on CUDA tensors the hand-written kernel K11
    (`csrc/intersect.cu` `hit_rects_kernel`: packed rows in shared tiles,
    several rays a thread, a branch on the row's axis) over
    `rect_table(rc)`, which the staged path builds once per trace and
    passes in; it raises if an operand is not float32 or the launch fails.
    On CPU tensors the plain version `ops.rect.hit_rects`, what the kernel
    is held against on the card;
  * backward: the JAX `custom_vjp`'s: misses carry no gradient, and torch
    autograd of t = (k - o_f) / d_f on the winning rect's gathered row
    (`_winning_t`, d_f = 0 guarded) gives the cotangents of the rect table's
    float fields, o and d.

`hit_rects_twin` is the plain twin of the kernel's design (its loop order,
packed rows, R rays a thread), for the CPU tests. The TPU kernel's one-hot
axis matrices (MXU products picking o_f, d_f, ...) are layout: the kernel
reads the axis id and branches on it, the whole warp at once.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch.ops import rect as rect_ops
from raytracer_weekend_tpu_torch.ops.cuda.sphere_intersect import (
    _winner_vjp, kernel_order_walk)
from raytracer_weekend_tpu_torch.scene.data import Rects
from raytracer_weekend_tpu_torch.textures import _rows

# Launches of K11 in this process; only the launch in `_launch` adds to it.
LAUNCHES = 0

# Columns of a row of the kernel's packed rect table, 2 float4 (the comment
# at `kRectQ` in csrc/intersect.cu).
TABLE_ROWS = ("axis", "valid", "k", "pad", "a0", "a1", "b0", "b1")
# The kernel's rays a thread, threads a block and rows a shared tile
# (kRectRays, kRectBlock, kRectTile in csrc/intersect.cu), for the twin.
RAYS, BLOCK, TILE = 2, 128, 128
ENTRY = "rtw_hit_rects"


def rect_table(rc: Rects) -> torch.Tensor:
    """(R, len(TABLE_ROWS)) packed table from the detached fields; the axis
    id and valid as floats (0, 1 or 2; 1 or 0)."""
    f = rc.k.dtype
    with torch.no_grad():
        return torch.stack([rc.axis.to(f), rc.valid.to(f), rc.k,
                            torch.zeros_like(rc.k), rc.a0, rc.a1, rc.b0,
                            rc.b1], dim=1).contiguous()


def ray_operands(o, d):
    """The kernel's per-ray operands: o and d."""
    return o.contiguous(), d.contiguous()


def _launch(table, rays, t_min: float):
    """One launch of K11 on prebuilt operands -> (t, idx int32)."""
    global LAUNCHES
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    out = _build.launch_closest_hit(ENTRY, rays, table, table.shape[0],
                                    t_min, (table.shape[0], len(TABLE_ROWS)))
    LAUNCHES += 1
    return out


def _winning_t(rc: Rects, o, d, idx):
    """t on each lane's winning rect (the JAX `_winning_t`)."""
    axis = _rows(rc.axis, idx).long()[:, None]
    o_f = torch.gather(o, 1, axis)[:, 0]
    d_f = torch.gather(d, 1, axis)[:, 0]
    return (_rows(rc.k, idx) - o_f) / torch.where(d_f == 0.0, 1.0, d_f)


class _HitRects(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_min, table, o, d, *fields):
        if o.device.type == "cpu":
            with torch.no_grad():
                t, idx = rect_ops.hit_rects(Rects(*fields), o, d, t_min)
            idx = idx.to(torch.int32)
        elif o.device.type == "cuda":
            t, idx = _launch(table, ray_operands(o, d), t_min)
        else:
            raise NotImplementedError(f"no rect intersection on {o.device}")
        ctx.save_for_backward(t, idx, o, d, *fields)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, ct_t, _):
        t, idx, *ins = ctx.saved_tensors
        return (None, None, *_winner_vjp(ctx, ins, ct_t, t, lambda o, d, *f:
                                         _winning_t(Rects(*f), o, d,
                                                    idx.long())))


def hit_rects_kernel(rc: Rects, o, d, t_min: float, table=None):
    """Closest rect per ray -> (t (B,) f32, idx (B,) int32): K11 on a card
    over `table` (`rect_table(rc)`, built here when None), the plain
    version on the CPU; differentiable in the rect table's float fields, o
    and d."""
    if table is None and o.device.type == "cuda":
        table = rect_table(rc)
    return _HitRects.apply(float(t_min), table, o, d, *rc)


# ---- the plain twin of the kernel's design ----------------------------------

def hit_rects_twin(rc: Rects, o, d, t_min: float, rays: int = RAYS,
                   block: int = BLOCK, tile: int = TILE):
    """Plain twin of K11's design on CPU tensors -> (t (B,) f32, idx (B,)
    int32): the rows read from the packed `rect_table(rc)`, walked in the
    kernel's order (`sphere_intersect.kernel_order_walk`); an invalid row
    skipped; every other pair takes the division and the exact test of
    `ops.rect.hit_rects`. The design's claim is that this is `hit_rects`
    bit for bit."""
    cols = dict(zip(TABLE_ROWS, rect_table(rc).unbind(1)))
    f, a, b = rect_ops._axes(cols["axis"])
    t = (cols["k"][None, :] - o[:, f]) / d[:, f]
    av = o[:, a] + t * d[:, a]
    bv = o[:, b] + t * d[:, b]
    hit = ((t >= t_min) & (av >= cols["a0"]) & (av <= cols["a1"])
           & (bv >= cols["b0"]) & (bv <= cols["b1"]))
    n = o.shape[0]

    def pair(c, best):
        if not bool(cols["valid"][c] > 0):
            return torch.zeros((n,), dtype=torch.bool), best
        return hit[:, c], t[:, c]

    return kernel_order_walk(n, rc.k.shape[0], rays, block, tile, pair)
