"""Wavefront path-tracing integrator (port of `integrator.py`).

Spheres, axis-aligned rects, triangles and constant-density media with
solid, checker, noise, image and uv-debug textures.
The reference's recursion `emitted + attenuation * sample_ray(...)` is
re-associated into the iterative form

    radiance  += throughput * emitted
    throughput *= attenuation

carried through a loop over bounce depth with SoA ray state. A miss adds
`throughput * background` and stops the lane; a light or an absorbing metal
stops it too. Each family gives its closest candidate per ray, and the
families merge in the JAX order (spheres, rects, triangles, media) with a
strict `<`, so on an exact tie the earlier family keeps the lane.

The closest hit of spheres, rects and triangles follows `cfg.use_pallas`
and the scene's trees (`SceneData.sphere_bvh`, `triangle_bvh`; the builder
records them above 512 spheres and 64 triangles), as the JAX package's
does (`_kernels_on`, `hit_routes`):
  * True: the closest-hit kernels K10-K12 (`ops.cuda.sphere_intersect`,
    `rect_intersect`, `triangle_intersect`), tree or not, each a
    torch.autograd.Function whose backward re-derives the winner's t on its
    gathered row; on CPU tensors their forward is the plain version. This
    is JAX's Pallas route;
  * "auto" (the default) on CUDA: a family without a tree takes K10-K12; a
    family with one takes the BVH kernel (`ops.cuda.bvh_traverse`, a
    Function of the same kind);
  * "auto" on the CPU, and False on any device: a family with a tree walks
    it with the plain `ops.bvh.traverse` (JAX with Pallas off), one without
    takes the plain brute force (`ops.sphere`, `ops.rect`, `ops.triangle`).
    A plain reference that traces the staged path on a card passes False.
A trace on a card builds the kernels' tables once (`kernel_tables`) for
all its bounces. Media always take `ops.volume.hit_volumes`: JAX has no
kernel for them. The tree's leaf tests write the quadratic in another
order than the brute force, and on an exact tie the tree keeps the first
leaf in DFS order where the brute force keeps the lowest row.

`render_image` dispatches on the scene's device:
  * CUDA, and `fused_eligible`: the hand-written CUDA megakernel
    (`ops.cuda.megakernel.render_fused`; a whole frame at `max_depth >= 16`
    renders in depth phases with compaction between them,
    `render_fused_deep`).
  * CUDA, any other scene (a uv-debug sphere, a medium with a checker
    albedo, ...): the staged path (`render_chunk`) in `cfg.ray_batch`
    chunks, with K10-K12 under "auto".
  * CPU: the plain staged path.
A build, load or launch failure raises; nothing falls back to the plain
path.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from raytracer_weekend_tpu_torch import materials as mat_mod
from raytracer_weekend_tpu_torch import rng as rt_rng
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.camera import Camera, get_rays
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.collectives import all_sum, gather
from raytracer_weekend_tpu_torch.ops import rect as rect_ops
from raytracer_weekend_tpu_torch.ops import sphere as sphere_ops
from raytracer_weekend_tpu_torch.ops import triangle as tri_ops
from raytracer_weekend_tpu_torch.ops import volume as vol_ops
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic
from raytracer_weekend_tpu_torch.utils import metrics
from raytracer_weekend_tpu_torch.vecmath import dot

_INF = math.inf

# Family ids for the winner select.
_FAM_NONE, _FAM_SPHERE, _FAM_RECT, _FAM_TRI, _FAM_VOL = -1, 0, 1, 2, 3


def _kernels_on(cfg: RenderConfig, device: torch.device | str) -> bool:
    """The closest-hit kernels K10-K12 take this render (the JAX
    `pallas_on`): `use_pallas` True, or "auto" on a CUDA device."""
    return cfg.use_pallas is True or (
        cfg.use_pallas == "auto" and torch.device(device).type == "cuda")


def hit_routes(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
               device: torch.device | str) -> dict:
    """How each family's closest hit is found for this render -> {"spheres",
    "rects", "triangles": "kernel" (K10-K12), "bvh" (the BVH kernel), "tree"
    (the plain traverse) or "plain" (the plain brute force)}."""
    kernels = _kernels_on(cfg, device)
    routes = {"rects": "kernel" if kernels else "plain"}
    for fam, tree, has in (("spheres", scene.sphere_bvh, static.sphere_bvh),
                           ("triangles", scene.triangle_bvh,
                            static.triangle_bvh)):
        if not (has and tree is not None):
            routes[fam] = "kernel" if kernels else "plain"
        elif not kernels:
            routes[fam] = "tree"
        else:
            routes[fam] = "kernel" if cfg.use_pallas is True else "bvh"
    return routes


def kernel_tables(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                  device: torch.device | str):
    """The closest-hit kernels' tables of this scene's families, (spheres,
    rects, triangles), each None where the family is absent, built from the
    detached fields: K10-K12's tables, or `bvh_traverse.Tables` (the packed
    nodes and the leaf rows) for a family that takes the BVH kernel; None
    when no kernel launches for this render (off, or the CPU, where the
    Functions run the plain versions on the fields). A trace builds them
    once for all its bounces and none outlives it, so a parameter updated
    in place (a fit's Adam step) reaches the next trace."""
    if not _kernels_on(cfg, device) or torch.device(device).type != "cuda":
        return None
    from raytracer_weekend_tpu_torch.ops.cuda import (
        bvh_traverse, rect_intersect, sphere_intersect, triangle_intersect)

    routes = hit_routes(scene, static, cfg, device)
    if not static.n_spheres:
        tab_s = None
    elif routes["spheres"] == "bvh":
        tab_s = bvh_traverse.tables("spheres", scene.sphere_bvh,
                                    scene.spheres)
    else:
        tab_s = sphere_intersect.sphere_table(scene.spheres)
    if not static.n_triangles:
        tab_t = None
    elif routes["triangles"] == "bvh":
        tab_t = bvh_traverse.tables("triangles", scene.triangle_bvh,
                                    scene.triangles)
    else:
        tab_t = triangle_intersect.triangle_table(scene.triangles)
    return (tab_s, rect_intersect.rect_table(scene.rects)
            if static.n_rects else None, tab_t)


_FAMILIES = ("spheres", "rects", "triangles")


def _hit_fn(fam: str, route: str, tree, table):
    """The closest-hit function of family `fam` on its `hit_routes` route,
    with its kernel table (or BVH `Tables`) bound."""
    from raytracer_weekend_tpu_torch.ops.cuda import (
        bvh_traverse, rect_intersect, sphere_intersect, triangle_intersect)

    if route == "plain":
        return {"spheres": sphere_ops.hit_spheres, "rects": rect_ops.hit_rects,
                "triangles": tri_ops.hit_triangles}[fam]
    if route == "kernel":
        return partial({"spheres": sphere_intersect.hit_spheres_kernel,
                        "rects": rect_intersect.hit_rects_kernel,
                        "triangles": triangle_intersect.hit_triangles_kernel
                        }[fam], table=table)
    walk = (bvh_traverse.traverse_spheres if fam == "spheres"
            else bvh_traverse.traverse_triangles)
    return partial(walk, tree, tables=table, plain=route == "tree")


def _closest_hit(scene: SceneData, static: SceneStatic, o, d, time,
                 cfg: RenderConfig, seed, ray_id, depth, tables, geom=None):
    """Closest hit over the families -> (t, fam, idx int64) per ray. A
    medium's scatter candidate draws from (seed, ray_id, depth) and merges
    last. `tables` are the trace's `kernel_tables`.

    With `geom` (this rank's `ops.collectives.Axis` of the geometry axis) the
    sphere and triangle tables are this rank's row slices, and the winner
    is found over the axis, as JAX's `geom_axis` does: local winners carry
    the global row `i + g * local_rows`, every rank gathers the axis's t
    and takes the argmin (on a tie the lowest rank, `torch.argmin`'s rule
    and `jnp.argmin`'s), and the winning rank's fam and idx are summed to
    all. The gather carries no gradient: the returned t is the winner's on
    every rank, and on the lanes this rank won it is its own t, through
    which the gradient reaches the winning row.
    """
    B = o.shape[0]
    t_best = torch.full((B,), _INF, device=o.device)
    fam = torch.full((B,), _FAM_NONE, dtype=torch.int32, device=o.device)
    idx = torch.zeros((B,), dtype=torch.int64, device=o.device)
    routes = hit_routes(scene, static, cfg, o.device)
    tabs = dict(zip(_FAMILIES, tables or (None,) * 3))
    trees = {"spheres": scene.sphere_bvh, "rects": None,
             "triangles": scene.triangle_bvh}
    hit_s, hit_r, hit_t = (_hit_fn(f, routes[f], trees[f], tabs[f])
                           for f in _FAMILIES)
    def globalized(hit, rows):
        """A sharded family's (t, row of this rank's slice) -> (t, row)."""
        if geom is None or geom.index == 0:
            return hit
        return hit[0], hit[1].long() + geom.index * rows

    hits = []
    if static.n_spheres:
        hits.append((_FAM_SPHERE, globalized(
            hit_s(scene.spheres, o, d, time, cfg.t_min),
            scene.spheres.radius.shape[0])))
    if static.n_rects:
        hits.append((_FAM_RECT, hit_r(scene.rects, o, d, cfg.t_min)))
    if static.n_triangles:
        hits.append((_FAM_TRI, globalized(
            hit_t(scene.triangles, o, d, cfg.t_min),
            scene.triangles.mat.shape[0])))
    if static.n_volumes:
        hits.append((_FAM_VOL, vol_ops.hit_volumes(
            scene.volumes, o, d, cfg.t_min, seed, ray_id, depth,
            use_log10=cfg.use_log10_volume_sampling)))
    for fam_id, (t_new, i_new) in hits:
        better = t_new < t_best
        t_best = torch.where(better, t_new, t_best)
        fam = torch.where(better, fam_id, fam)
        idx = torch.where(better, i_new.long(), idx)   # the kernels' int32
    if geom is not None and geom.size > 1:
        t_all = gather(t_best, geom)                            # (G, B)
        k = torch.argmin(t_all, dim=0)
        mine = k == geom.index
        t_best = torch.where(mine, t_best, t_all.gather(0, k[None])[0])
        fi = all_sum(torch.where(mine, torch.stack([fam.long(), idx]), 0),
                     geom)
        fam, idx = fi[0].to(torch.int32), fi[1]
    return t_best, fam, idx


def _hit_record(scene: SceneData, static: SceneStatic, o, d, time, t, fam,
                idx, geom=None):
    """Hit record of the winning family -> (p, normal, front_face, u, v, mat).

    With `geom`, a sphere or triangle row lives on one rank of the axis:
    that rank writes the record, and a masked sum over the axis gives it to
    every rank; rects and media are replicated, so rank 0 writes theirs (JAX
    `_hit_record`'s rule; the sum is differentiable, so the gradient of the
    record returns to the writer)."""
    B = o.shape[0]
    p = torch.zeros((B, 3), device=o.device)
    outward = torch.zeros((B, 3), device=o.device)
    u = torch.zeros((B,), device=o.device)
    v = torch.zeros((B,), device=o.device)
    mat_id = torch.zeros((B,), dtype=torch.int32, device=o.device)
    sharded = geom is not None and geom.size > 1
    g = geom.index if sharded else 0
    wrote = torch.zeros((B,), dtype=torch.bool, device=o.device) if sharded \
        else None

    def local(rows):
        """(row in this rank's slice, this rank holds it) per lane."""
        if not sharded:
            return idx, None
        lo = g * rows
        return (torch.clamp(idx - lo, 0, rows - 1),
                (idx >= lo) & (idx < lo + rows))

    # Guard t for missed lanes so records never see inf; each family reads
    # row 0 for the lanes another family won.
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    replicated = None if not sharded else torch.full((B,), g == 0,
                                                     device=o.device)
    records = []
    if static.n_spheres:
        i_s, mine_s = local(scene.spheres.radius.shape[0])
        records.append((_FAM_SPHERE, i_s, mine_s,
                        lambda i: sphere_ops.sphere_record(
                            scene.spheres, i, o, d, time, t_safe)))
    if static.n_rects:
        records.append((_FAM_RECT, idx, replicated,
                        lambda i: rect_ops.rect_record(
                            scene.rects, i, o, d, t_safe)))
    if static.n_triangles:
        i_t, mine_t = local(scene.triangles.mat.shape[0])
        records.append((_FAM_TRI, i_t, mine_t,
                        lambda i: tri_ops.triangle_record(
                            scene.triangles, i, o, d, t_safe)))
    if static.n_volumes:
        records.append((_FAM_VOL, idx, replicated,
                        lambda i: vol_ops.volume_record(
                            scene.volumes, i, o, d, t_safe)))
    for fam_id, rows, mine, record in records:
        m = fam == fam_id
        if mine is not None:
            m = m & mine
        rp, rn, ru, rv, rm = record(torch.where(m, rows, 0))
        p = torch.where(m[:, None], rp, p)
        outward = torch.where(m[:, None], rn, outward)
        u = torch.where(m, ru, u)
        v = torch.where(m, rv, v)
        mat_id = torch.where(m, rm, mat_id)
        if sharded:
            wrote = wrote | m

    if sharded:
        rec = torch.cat([p, outward, u[:, None], v[:, None]], dim=1)
        rec = all_sum(torch.where(wrote[:, None], rec, 0.0), geom)
        p, outward, u, v = rec[:, 0:3], rec[:, 3:6], rec[:, 6], rec[:, 7]
        mat_id = all_sum(torch.where(wrote, mat_id, 0), geom)

    # Front-face normal flip; a medium scatter is front-facing (its
    # isotropic phase reads neither).
    front_face = (dot(d, outward) < 0.0) | (fam == _FAM_VOL)
    normal = torch.where(front_face[:, None], outward, -outward)
    return p, normal, front_face, u, v, mat_id


def trace_rays(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
               o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
               ray_id: torch.Tensor, seed, return_stats: bool = False,
               geom=None):
    """Estimate radiance for a batch of rays -> (B,3) f32.

    With `return_stats`, also the traced segment count (lanes alive at the
    start of each bounce, summed), a 0-d int64 tensor. `geom` as in
    `trace_lanes`.
    """
    radiance, segments = trace_lanes(scene, static, cfg, o, d, time, ray_id,
                                     seed, geom=geom)
    if return_stats:
        return radiance, segments.sum()
    return radiance


def trace_lanes(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                ray_id: torch.Tensor, seed, emit_paths: bool = False,
                emit_deferred: bool = False, *, d0: int = 0, carry=None,
                return_carry: bool = False, geom=None):
    """`trace_rays` with per-lane segment counts -> ((B,3) f32, (B,) int32).

    With `emit_paths`, also the per-bounce winner codes (B, max_depth)
    int32, where the lane was alive and hit: 1 + 4*idx for sphere `idx`,
    2 + 4*idx for planar primitive `idx` of the unified planar index (rects
    first, then triangles offset by `static.n_rects`), 3 + 4*idx for medium
    `idx`; else 0. These are the JAX megakernel's `emit_paths` codes (there
    f32); `replay.replay_rays` re-traces a path from them.

    With `emit_deferred`, noise and image texels are shaded as 1.0 (so the
    radiance lacks them) and the per-bounce deferred-texture records follow
    the codes: ctb (B, D, 3) f32, the bounce's radiance contribution (miss
    background or emission, texels 1.0); abc (B, D, 3) f32, the hit point
    for a noise texel, the pre-flip outward normal for a sphere's image
    texel, (u, v, 0) in the primitive's own in-plane coordinates for a
    planar image texel, else 0; dcode (B, D) int32, +(texid + 1) (sphere or
    noise) or -(texid + 1) (planar image) where a live hit's texel was
    deferred, else 0. This is the plain version of the fused kernel's
    deferred-texture records (`ops.cuda.megakernel.combine_deferred` folds
    them back in). A medium scatter records nothing.

    One depth phase of the depth-phased render (the plain version of the
    kernel's phase I/O): bounces d0 .. d0 + max_depth - 1, the random
    numbers keyed on the absolute depth, from `carry` = (throughput,
    radiance, alive, segments) where given (else a fresh lane); with
    `return_carry` the outputs end with the lane's (o, d, throughput,
    radiance, alive, segments) after the phase.

    With `geom` (the `ops.collectives.Axis` of a geometry-sharded mesh), the
    scene's sphere and triangle tables (and their trees) are this rank's
    row slices, and every bounce combines the closest hit and the hit
    record over the axis (`_closest_hit`, `_hit_record`): every rank of the
    axis traces the same lanes and returns the same radiance. The codes
    then carry global rows; the deferred records are not sharded.
    """
    if geom is not None and emit_deferred:
        raise ValueError("the deferred records are not traced on a "
                         "geometry-sharded mesh")
    B = o.shape[0]
    background = scene.background
    if carry is None:
        throughput = torch.ones((B, 3), device=o.device)
        radiance = torch.zeros((B, 3), device=o.device)
        alive = torch.ones((B,), dtype=torch.bool, device=o.device)
        segments = torch.zeros((B,), dtype=torch.int32, device=o.device)
    else:
        throughput, radiance, alive, segments = carry
    codes, records = [], []
    pla = None
    if emit_deferred and (static.n_rects or static.n_triangles):
        from raytracer_weekend_tpu_torch import replay

        pla = replay._pack_planar(scene, static)

    tables = kernel_tables(scene, static, cfg, o.device)
    for depth in range(d0, d0 + cfg.max_depth):
        segments = segments + alive.to(torch.int32)
        t, fam, idx = _closest_hit(scene, static, o, d, time, cfg, seed,
                                   ray_id, depth, tables, geom)
        hit_mask = torch.isfinite(t)

        # Miss -> background, terminate.
        miss = alive & ~hit_mask
        miss_c = torch.where(miss[:, None], throughput * background, 0.0)
        radiance = radiance + miss_c
        alive = alive & hit_mask
        idx32 = idx.to(torch.int32)
        planar_idx = torch.where(fam == _FAM_TRI, idx32 + static.n_rects,
                                 idx32)
        if emit_paths:
            code = torch.where(fam == _FAM_SPHERE, 1 + 4 * idx32,
                               2 + 4 * planar_idx)
            code = torch.where(fam == _FAM_VOL, 3 + 4 * idx32, code)
            codes.append(torch.where(alive, code, 0))

        p, normal, front_face, u, v, mat_id = _hit_record(
            scene, static, o, d, time, t, fam, idx, geom)
        sc = mat_mod.scatter(
            scene.materials, scene.textures, mat_id, d, p, normal, front_face,
            u, v, seed, ray_id, depth,
            has_noise=static.has_noise, has_image=static.has_image,
            defer=emit_deferred)

        emit_c = torch.where(alive[:, None], throughput * sc.emitted, 0.0)
        radiance = radiance + emit_c
        if emit_deferred:
            records.append(_deferred_record(
                scene, p, normal, front_face, mat_id, fam, planar_idx, alive,
                pla) + (miss_c + emit_c,))
        throughput = torch.where(alive[:, None],
                                 throughput * sc.attenuation, throughput)
        alive = alive & sc.alive

        # The scattered ray keeps the parent's shutter time.
        o = torch.where(alive[:, None], p, o)
        d = torch.where(alive[:, None], sc.direction, d)
    # Depth exhausted with live rays -> they contribute black.
    out = (radiance, segments)
    if emit_paths:
        out += (torch.stack(codes, dim=1),)
    if emit_deferred:
        dcode, abc, ctb = (torch.stack(r, dim=1) for r in zip(*records))
        out += (ctb, abc, dcode)
    if return_carry:
        out += ((o, d, throughput, radiance, alive, segments),)
    return out


def _deferred_record(scene: SceneData, p, normal, front_face, mat_id, fam,
                     planar_idx, alive, pla):
    """One bounce's (dcode (B,) int32, abc (B,3)) deferred-texture record
    (see `trace_lanes`); `pla` is `replay._pack_planar`'s table or None."""
    tid = scene.materials.tex[mat_id.long()].long()
    ttype = scene.textures.ttype[tid]
    is_noise = ttype == tex_mod.NOISE
    deferred = (alive & (is_noise | (ttype == tex_mod.IMAGE))
                & (fam != _FAM_VOL))
    planar = (fam == _FAM_RECT) | (fam == _FAM_TRI)
    abc = torch.where(front_face[:, None], normal, -normal)  # pre-flip
    if pla is not None:
        row = pla[torch.where(planar, planar_idx, 0).long()]
        u_b = dot(row[:, 4:7], p) + row[:, 7]
        v_b = dot(row[:, 8:11], p) + row[:, 11]
        uv0 = torch.stack([u_b, v_b, torch.zeros_like(u_b)], dim=-1)
        abc = torch.where(planar[:, None], uv0, abc)
    abc = torch.where(is_noise[:, None], p, abc)
    abc = torch.where(deferred[:, None], abc, 0.0)
    code = (tid + 1).to(torch.int32)
    dcode = torch.where(deferred, torch.where(planar, -code, code), 0)
    return dcode, abc


def _pixel_rays(cam: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor, seed):
    """Primary rays for (pixel, sample) lanes.

    pixel_ids enumerate pixel*spp + sample lanes. Film jitter:
    u=(col+U)/(w-1), v=(row+U)/(h-1) with row 0 at the image bottom.
    Returns (o, d, time, ray_id); ray_id is the lane id mod 2^32 (int64).
    """
    spp = cfg.samples_per_pixel
    pix = torch.div(pixel_ids, spp, rounding_mode="floor")
    col = (pix % cfg.width).to(torch.float32)
    row_top = torch.div(pix, cfg.width, rounding_mode="floor")
    row = (cfg.height - 1 - row_top).to(torch.float32)  # bottom-up rows

    ray_id = pixel_ids.to(torch.int64) & 0xFFFFFFFF
    uj = rt_rng.rand4(seed, ray_id, 0, rt_rng.SALT_PIXEL_JITTER)
    u = (col + uj[..., 0]) / float(cfg.width - 1)
    v = (row + uj[..., 1]) / float(cfg.height - 1)

    o, d, time = get_rays(cam, u, v, seed, ray_id)
    return o, d, time, ray_id


def render_chunk(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                 cam: Camera, pixel_ids: torch.Tensor, seed,
                 return_stats: bool = False, geom=None):
    """Trace one chunk of (pixel, sample) lanes -> per-lane radiance (B,3)
    (with `return_stats` and `geom` as in `trace_rays`)."""
    o, d, time, ray_id = _pixel_rays(cam, cfg, pixel_ids, seed)
    return trace_rays(scene, static, cfg, o, d, time, ray_id, seed,
                      return_stats=return_stats, geom=geom)


# The differentiable path replay (the fused render's backward) lives in
# replay.py; re-exported here as in the JAX package.
from raytracer_weekend_tpu_torch.replay import replay_rays  # noqa: E402, F401


def fused_eligible(static: SceneStatic, cfg: RenderConfig,
                   device: torch.device | str) -> bool:
    """True when the CUDA megakernel renders this scene on `device`: a card,
    `fused_supported`, and kernels not turned off (`use_pallas` False), as
    the JAX `fused_eligible` requires `pallas_on`."""
    from raytracer_weekend_tpu_torch.ops.cuda.megakernel import fused_supported

    return (torch.device(device).type == "cuda"
            and cfg.use_pallas is not False and fused_supported(static, cfg))


def render_image(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                 cam: Camera, progress=None) -> torch.Tensor:
    """Full-frame render -> (H, W, 3) accumulated color SUMS over spp.

    Runs on the scene's device; the camera must be on it too. Divide by spp
    and gamma-correct with `utils.image.tone_map`. On a card a scene that
    `fused_eligible` admits takes the megakernel, any other the staged path
    (with K10-K12 unless `use_pallas` is False), in `cfg.ray_batch` chunks.
    """
    with metrics.span("rtw.render_image"):
        device = scene.device
        n_lanes = cfg.n_rays
        batch = cfg.ray_batch or n_lanes
        use_fused = fused_eligible(static, cfg, device)
        counting = metrics.on()

        chunks = []
        for start in range(0, n_lanes, batch):
            size = min(batch, n_lanes - start)
            if use_fused:
                from raytracer_weekend_tpu_torch.ops.cuda.megakernel import (
                    render_fused)
                colors, segs = render_fused(scene, cfg, cam, start, size,
                                            cfg.seed, static=static)
            else:
                ids = start + torch.arange(size, dtype=torch.int64,
                                           device=device)
                out = render_chunk(scene, static, cfg, cam, ids, cfg.seed,
                                   return_stats=counting)
                colors, segs = out if counting else (out, None)
            if counting:
                metrics.count("segments", segs)
            chunks.append(colors)
            if progress is not None:
                progress(start + size, n_lanes)
        lanes = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        # Lanes are ordered pixel*spp + sample: the spp sum is a reshape +
        # sum.
        acc = lanes.reshape(cfg.n_pixels, cfg.samples_per_pixel, 3).sum(dim=1)
        return acc.reshape(cfg.height, cfg.width, 3)
