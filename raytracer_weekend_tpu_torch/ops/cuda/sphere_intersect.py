"""Closest moving sphere per ray: kernel K10, inside a torch.autograd.Function.

Counterpart of `raytracer_weekend_tpu/ops/pallas/sphere_intersect.py`.
`hit_spheres_kernel(sp, o, d, time, t_min)` returns (t (B,) f32, +inf on a
miss; idx (B,) int32, the lowest row among equal t, 0 on a miss):

  * forward: on CUDA tensors the hand-written kernel K10
    (`csrc/intersect.cu` `hit_spheres_kernel`, built at first use by
    `_build.py`), which raises if an operand is not float32 or the launch
    fails; on CPU tensors the plain version `ops.sphere.hit_spheres`, what
    the kernel is held against on the card (the counterpart of Pallas
    interpret mode);
  * backward: the JAX `custom_vjp`'s. Misses carry no gradient; every other
    lane re-derives its accepted root on the winning sphere's gathered row
    in the direct form o - c(t) (`_winning_root`), and torch autograd of that
    one-row recompute gives the cotangents of the sphere table's float
    fields, o, d and time. idx gets none.

The TPU kernel's MXU pairwise dots, (3, TB) ray planes and padded tables are
layout and are not carried over.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops
from raytracer_weekend_tpu_torch.scene.data import Spheres
from raytracer_weekend_tpu_torch.textures import _rows
from raytracer_weekend_tpu_torch.vecmath import dot

# Launches of K10 in this process; only the launch in `_launch` adds to it.
LAUNCHES = 0

# Rows of the kernel's sphere table, in the order of `enum SRow` in
# csrc/intersect.cu.
TABLE_ROWS = ("c0x", "c0y", "c0z", "dcx", "dcy", "dcz", "t0", "dt", "r2",
              "c0_sq", "c0_dc", "dc_sq", "valid")


def sphere_table(sp: Spheres) -> torch.Tensor:
    """(len(TABLE_ROWS), S) table: the per-sphere terms of the expanded
    quadratic as the plain version computes them (`ops.sphere.sphere_terms`),
    and valid as 1/0."""
    dc, dt, r2, c0_sq, c0_dc, dc_sq = sphere_ops.sphere_terms(sp)
    return torch.stack([*sp.c0.unbind(1), *dc.unbind(1), sp.t0, dt, r2,
                        c0_sq, c0_dc, dc_sq,
                        sp.valid.to(sp.c0.dtype)]).contiguous()


def _launch(sp: Spheres, o, d, time, t_min: float):
    """One launch of K10 -> (t, idx int32)."""
    global LAUNCHES
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    o, d, time = o.contiguous(), d.contiguous(), time.contiguous()
    ray_sc = torch.stack(sphere_ops.ray_terms(o, d), dim=1)
    out = _build.launch_closest_hit("rtw_hit_spheres", (o, d, time, ray_sc),
                                    sphere_table(sp), t_min)
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
    def forward(ctx, t_min, o, d, time, *fields):
        sp = Spheres(*fields)
        if o.device.type == "cpu":
            with torch.no_grad():
                t, idx = sphere_ops.hit_spheres(sp, o, d, time, t_min)
            idx = idx.to(torch.int32)
        elif o.device.type == "cuda":
            t, idx = _launch(sp, o, d, time, t_min)
        else:
            raise NotImplementedError(f"no sphere intersection on {o.device}")
        ctx.t_min = t_min
        ctx.save_for_backward(t, idx, o, d, time, *fields)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, ct_t, _):
        t, idx, *ins = ctx.saved_tensors
        return (None, *_winner_vjp(ctx, ins, ct_t, t, lambda o, d, time, *f:
                                   _winning_root(Spheres(*f), o, d, time,
                                                 idx.long(), ctx.t_min)))


def _winner_vjp(ctx, ins, ct_t, t, recompute):
    """Cotangents of `ins` (the Function's inputs after t_min) through the
    one-row recompute of the winner's t, misses zeroed (the JAX `_bwd`)."""
    wanted = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]
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


def hit_spheres_kernel(sp: Spheres, o, d, time, t_min: float):
    """Closest sphere per ray -> (t (B,) f32, idx (B,) int32): K10 on a
    card, the plain version on the CPU; differentiable in the sphere table's
    float fields, o, d and time."""
    return _HitSpheres.apply(float(t_min), o, d, time, *sp)
