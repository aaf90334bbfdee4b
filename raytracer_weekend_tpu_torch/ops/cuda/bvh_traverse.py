"""Closest hit through the skip-link BVH: kernels BVH-sph and BVH-tri,
inside a torch.autograd.Function.

The JAX package walks the tree with a `lax.while_loop`
(`raytracer_weekend_tpu/ops/bvh.py:43` `traverse`), not in Pallas, so these
replace no TPU kernel; they are what makes the tree usable on the card.
`traverse_spheres(bvh, sp, o, d, time, t_min, tables)` and
`traverse_triangles(bvh, tr, o, d, t_min, tables)` return (t (B,) f32,
+inf where no leaf is hit; prim (B,) int32, the first leaf in DFS order
among equal t, 0 on a miss):

  * forward: on CUDA tensors the hand-written kernel (`csrc/bvh.cu`, built
    at first use by `_build.py`) over `Tables` (the packed nodes and the
    leaf rows), which the staged path builds once per trace and passes in
    (`integrator.kernel_tables`); it raises if an operand is not float32 or
    the launch fails. On CPU tensors, or with `plain=True` on any device,
    the plain version, `ops.bvh.traverse` with its leaf tests, which the
    kernel is held to bit for bit on the card;
  * backward: misses carry no gradient; every other lane re-derives its t
    on its winning row with the leaf test's own arithmetic (the oc form for
    spheres, `_winning_root`; the scalar triple form for triangles,
    `_winning_t`), and torch autograd of that one-row recompute gives the
    cotangents of the table's float fields, o, d and time. The tree, prim
    and the tables get none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_weekend_tpu_torch.ops import bvh as bvh_ops
from raytracer_weekend_tpu_torch.ops.cuda.sphere_intersect import (
    _winner_vjp, sphere_table)
from raytracer_weekend_tpu_torch.scene.data import Spheres, Triangles
from raytracer_weekend_tpu_torch.textures import _rows

# Launches of each kernel in this process; only `_launch` adds to them.
SPHERE_LAUNCHES = 0
TRIANGLE_LAUNCHES = 0

# A node: (bmin.xyz, prim) and (bmax.xyz, skip), prim and skip as int32 bits.
NODE_ROWS = ("bminx", "bminy", "bminz", "prim", "bmaxx", "bmaxy", "bmaxz",
             "skip")
# A triangle row, 4 float4 (`triangle_leaf` in csrc/bvh.cu); the sphere
# leaf reads K10's table (`sphere_intersect.TABLE_ROWS`).
TRIANGLE_ROWS = ("v0x", "v0y", "v0z", "valid", "abx", "aby", "abz", "pad",
                 "acx", "acy", "acz", "pad", "nx", "ny", "nz", "pad")
ENTRIES = {"spheres": "rtw_bvh_spheres", "triangles": "rtw_bvh_triangles"}


class Tables(NamedTuple):
    """One family's operands of the kernel, built once a trace."""

    nodes: torch.Tensor  # (M, 8) f32
    rows: torch.Tensor   # (P, 16) f32


def node_table(bvh: bvh_ops.Bvh) -> torch.Tensor:
    """(M, 8) packed nodes, prim and skip carried as int32 bits."""
    with torch.no_grad():
        return torch.cat([bvh.bmin.float(),
                          bvh.prim.to(torch.int32)[:, None].view(
                              torch.float32),
                          bvh.bmax.float(),
                          bvh.skip.to(torch.int32)[:, None].view(
                              torch.float32)], dim=1).contiguous()


def triangle_rows(tr: Triangles) -> torch.Tensor:
    """(T, 16) rows {v0, valid; ab; ac; n} from the detached fields, the
    values the plain leaf test computes (`ops.bvh.triangle_edges`)."""
    with torch.no_grad():
        ab, ac, n = bvh_ops.triangle_edges(tr)
        zero = torch.zeros_like(tr.v0[:, :1])
        return torch.cat([tr.v0, tr.valid.to(tr.v0.dtype)[:, None], ab, zero,
                          ac, zero, n, zero], dim=1).contiguous()


def tables(kind: str, bvh: bvh_ops.Bvh, prims) -> Tables:
    """The kernel's operands for `kind` ("spheres" or "triangles")."""
    rows = (sphere_table(prims) if kind == "spheres"
            else triangle_rows(prims))
    return Tables(node_table(bvh), rows)


def ray_operands(kind: str, o, d, time=None):
    """The per-ray operands in the C entry's order."""
    rays = (o.contiguous(), d.contiguous())
    return rays + (time.contiguous(),) if kind == "spheres" else rays


def _launch(kind: str, tabs: Tables, rays, t_min: float, counts=None):
    """One launch on prebuilt operands -> (t, prim int32). With `counts` (a
    zeroed (2,) int64 tensor) the kernel adds the nodes visited and the
    leaves tested there; such a probe is not counted as a launch."""
    global SPHERE_LAUNCHES, TRIANGLE_LAUNCHES
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    nodes, rows = tabs
    device = nodes.device
    n = rays[0].shape[0]
    width = 16
    for x in (*rays, nodes, rows):
        if (x.dtype != torch.float32 or x.device != device
                or device.type != "cuda" or not x.is_contiguous()):
            raise ValueError(f"{ENTRIES[kind]}: every operand must be a "
                             f"contiguous float32 CUDA tensor on one device; "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if (any(x.shape[0] != n for x in rays) or n >= 2**31
            or any(x.shape[1:] != (3,) for x in rays[:2])
            or nodes.ndim != 2 or nodes.shape[1] != len(NODE_ROWS)
            or nodes.shape[0] < 1 or rows.ndim != 2
            or rows.shape[1] != width or nodes.data_ptr() % 16
            or rows.data_ptr() % 16):
        raise ValueError(f"{ENTRIES[kind]}: rays of "
                         f"{[tuple(x.shape) for x in rays]} against nodes of "
                         f"{tuple(nodes.shape)} and rows of "
                         f"{tuple(rows.shape)} (want (M, 8) and (P, 16), "
                         f"16-byte aligned)")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, ENTRIES[kind])(
            *(x.data_ptr() for x in rays), n, nodes.data_ptr(),
            nodes.shape[0], rows.data_ptr(), float(t_min), t.data_ptr(),
            prim.data_ptr(), None if counts is None else counts.data_ptr(),
            stream)
    _build.check(lib, err, f"{ENTRIES[kind]} launch")
    if counts is None:
        if kind == "spheres":
            SPHERE_LAUNCHES += 1
        else:
            TRIANGLE_LAUNCHES += 1
    return t, prim


def count_work(kind: str, tabs: Tables, rays, t_min: float) -> dict:
    """The nodes visited and the leaves tested by one launch on these
    operands (the counting probe; not counted in the launch counts)."""
    counts = torch.zeros((2,), dtype=torch.int64, device=tabs.nodes.device)
    _launch(kind, tabs, rays, t_min, counts=counts)
    visited, leaves = (int(x) for x in counts.cpu())
    return {"nodes visited": visited, "leaves tested": leaves}


# ---- the one-row recomputes of the backward -----------------------------------

def _winning_root(sp: Spheres, o, d, time, idx, t_min: float):
    """The accepted root on each lane's winning sphere in the sphere leaf's
    oc form (the derivative of the t the forward returned): the first root
    where it is >= t_min, else the second."""
    c0, c1 = _rows(sp.c0, idx), _rows(sp.c1, idx)
    t0, t1, r = _rows(sp.t0, idx), _rows(sp.t1, idx), _rows(sp.radius, idx)
    w = ((time - t0) / (t1 - t0))[:, None]
    oc = o - (c0 + w * (c1 - c0))
    a = bvh_ops._sum3(d * d)
    half_b = bvh_ops._sum3(oc * d)
    c_term = bvh_ops._sum3(oc * oc) - r * r
    disc = half_b * half_b - a * c_term
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    root1 = (-half_b - sq) * inv_a
    root2 = (-half_b + sq) * inv_a
    return torch.where(root1 >= t_min, root1, root2)


def _winning_t(tr: Triangles, o, d, idx):
    """t on each lane's winning triangle in the triangle leaf's form."""
    v0 = _rows(tr.v0, idx)
    ab = _rows(tr.v1, idx) - v0
    ac = _rows(tr.v2, idx) - v0
    n = bvh_ops.cross3(ab, ac)
    det = -bvh_ops._sum3(d * n)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    return bvh_ops._sum3((o - v0) * n) * inv_det


def _plain(kind, bvh, prims, o, d, time, t_min):
    if kind == "spheres":
        test = bvh_ops.sphere_prim_test(prims, o, d, time, t_min)
    else:
        test = bvh_ops.triangle_prim_test(prims, o, d, t_min)
    return bvh_ops.traverse(bvh, o, d, t_min, test)


class _TraverseSpheres(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_min, aux, o, d, time, *fields):
        bvh, tabs, plain = aux
        if plain or o.device.type == "cpu":
            with torch.no_grad():
                t, prim = _plain("spheres", bvh, Spheres(*fields), o, d,
                                 time, t_min)
        elif o.device.type == "cuda":
            if tabs is None:
                tabs = tables("spheres", bvh, Spheres(*fields))
            t, prim = _launch("spheres", tabs,
                              ray_operands("spheres", o, d, time), t_min)
        else:
            raise NotImplementedError(f"no BVH walk on {o.device}")
        ctx.t_min = t_min
        ctx.save_for_backward(t, prim, o, d, time, *fields)
        ctx.mark_non_differentiable(prim)
        return t, prim

    @staticmethod
    def backward(ctx, ct_t, _):
        t, prim, *ins = ctx.saved_tensors
        return (None, None, *_winner_vjp(
            ctx, ins, ct_t, t, lambda o, d, time, *f: _winning_root(
                Spheres(*f), o, d, time, prim.long(), ctx.t_min)))


class _TraverseTriangles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_min, aux, o, d, *fields):
        bvh, tabs, plain = aux
        if plain or o.device.type == "cpu":
            with torch.no_grad():
                t, prim = _plain("triangles", bvh, Triangles(*fields), o, d,
                                 None, t_min)
        elif o.device.type == "cuda":
            if tabs is None:
                tabs = tables("triangles", bvh, Triangles(*fields))
            t, prim = _launch("triangles", tabs,
                              ray_operands("triangles", o, d), t_min)
        else:
            raise NotImplementedError(f"no BVH walk on {o.device}")
        ctx.save_for_backward(t, prim, o, d, *fields)
        ctx.mark_non_differentiable(prim)
        return t, prim

    @staticmethod
    def backward(ctx, ct_t, _):
        t, prim, *ins = ctx.saved_tensors
        return (None, None, *_winner_vjp(ctx, ins, ct_t, t, lambda o, d, *f:
                                         _winning_t(Triangles(*f), o, d,
                                                    prim.long())))


def traverse_spheres(bvh, sp: Spheres, o, d, time, t_min: float,
                     tables: Tables | None = None, plain: bool = False):
    """Closest sphere per ray through `bvh` -> (t (B,) f32, prim (B,)
    int32): BVH-sph on a card over `tables` (built here when None), the
    plain `ops.bvh.traverse` on the CPU or with `plain`; differentiable in
    the sphere table's float fields, o, d and time."""
    return _TraverseSpheres.apply(float(t_min), (bvh, tables, plain), o, d,
                                  time, *sp)


def traverse_triangles(bvh, tr: Triangles, o, d, t_min: float,
                       tables: Tables | None = None, plain: bool = False):
    """Closest triangle per ray through `bvh` -> (t (B,) f32, prim (B,)
    int32): BVH-tri on a card, the plain traverse on the CPU or with
    `plain`; differentiable in the triangle table's float fields, o and
    d."""
    return _TraverseTriangles.apply(float(t_min), (bvh, tables, plain), o,
                                    d, *tr)

