"""Staged closest axis-aligned rect hit and hit record (port of `ops/rect.py`).

All rects live in one table with a fixed-coordinate `axis` id. The JAX
package picks each rect's coordinates of the ray with (B,3)x(3,R) products
against one-hot axis matrices; here they are column gathers, which give the
same values exactly. This is the plain version that the CUDA megakernel's
planar branch is held against, in the staged form t = (k - o_f)/d_f: a ray
parallel to a rect divides by zero, gets t = +-inf (or NaN) and misses.
"""

from __future__ import annotations

import math

import torch

from raytracer_weekend_tpu_torch.scene.data import Rects
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import ray_at

_INF = math.inf


def _axes(axis: torch.Tensor):
    """(fixed, a, b) axis ids; the varying axes in UV order: axis 0 (YZ
    rect) (a, b) = (y, z), axis 1 (XZ) (x, z), axis 2 (XY) (x, y)."""
    axis = axis.long()
    return (axis, torch.where(axis == 0, 1, 0),
            torch.where(axis == 2, 1, 2))


def hit_rects(rc: Rects, o: torch.Tensor, d: torch.Tensor, t_min: float,
              t_max: float = _INF) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest rect hit per ray -> (t (B,), +inf on miss; idx (B,) int64).

    Ties go to the first (lowest) row, as `argmin` gives them.
    """
    f, a, b = _axes(rc.axis)
    t = (rc.k[None, :] - o[:, f]) / d[:, f]          # (B,R)
    av = o[:, a] + t * d[:, a]
    bv = o[:, b] + t * d[:, b]
    hit = ((t >= t_min) & (t <= t_max)
           & (av >= rc.a0[None, :]) & (av <= rc.a1[None, :])
           & (bv >= rc.b0[None, :]) & (bv <= rc.b1[None, :])
           & rc.valid[None, :])
    t_all = torch.where(hit, t, _INF)
    return torch.amin(t_all, dim=-1), torch.argmin(t_all, dim=-1)


def rect_record(rc: Rects, idx: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor, t: torch.Tensor):
    """Hit record for winning rows -> (p, outward_normal, u, v, mat).

    The outward normal is the + unit vector of the fixed axis; the UV is
    the normalized in-plane position. Rows are read by `textures._rows`.
    """
    idx = idx.long()
    f, a, b = _axes(_rows(rc.axis, idx))
    p = ray_at(o, d, t)
    av = torch.gather(p, 1, a[:, None])[:, 0]
    bv = torch.gather(p, 1, b[:, None])[:, 0]
    a0, a1 = _rows(rc.a0, idx), _rows(rc.a1, idx)
    b0, b1 = _rows(rc.b0, idx), _rows(rc.b1, idx)
    u = (av - a0) / (a1 - a0)
    v = (bv - b0) / (b1 - b0)
    outward = torch.nn.functional.one_hot(f, 3).to(p.dtype)
    return p, outward, u, v, _rows(rc.mat, idx)
