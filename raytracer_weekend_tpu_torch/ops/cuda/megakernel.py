"""Fused forward render: the CUDA megakernel and its plain twin.

Counterpart of `raytracer_weekend_tpu/ops/pallas/megakernel.py`, sphere
branch (K1), planar branch (K3: axis-aligned rects and triangles in one
table), volume branch (K5: constant-density media), deferred-texture
record arm (K6a) and phase I/O (K6b, `render_fused_deep`). `render_fused`
renders a window of lanes (lane = pixel*spp + sample) and returns per-lane
radiance and traced segment counts:

  * for a scene on a CUDA device it launches the hand-written kernel in
    `csrc/megakernel.cuh` (built at first use by `_build.py`) and raises if
    the library does not build or load, or the launch fails;
  * for a scene on the CPU it runs `render_fused_reference`, the plain torch
    version (`integrator._pixel_rays` + `integrator.trace_lanes`), which is
    what the CUDA kernel is held against on the card.

With `emit_paths=True` it also returns the per-bounce winner codes (n, D)
int32 where the lane was alive and hit: 1 + 4*idx for sphere idx, 2 + 4*idx
for planar primitive idx (rects first, then triangles), 3 + 4*idx for
medium idx; else 0. That is the JAX kernel's `emit_paths` output (there
f32), which the backward replays (`fused_diff.py`).

A whole frame at `max_depth >= 16` without codes renders in depth phases
(`render_fused_deep`): the kernel writes each lane's state after a phase of
bounces, the host gathers the live lanes and the next phase resumes them,
each ray on a group of G threads so that a few live lanes still fill the
card (`phase_group`). The planar loop stages packed plane rows
(`build_planar_test`) in shared memory and divides only for rows that pass
a division-free prefilter; `plane_candidate_plain` and
`closest_hit_grouped` are the plain twins of those two rules, for the CPU
tests.

Scenes with noise or image textures render in deferred-texture mode: the
kernel shades those texels as 1.0 and writes per-bounce records (ctb, abc,
dcode; see `integrator.trace_lanes`), and `combine_deferred` (or
`combine_deferred_single`, for one image sphere) evaluates the true texels
with `textures.texture_value` and folds them back in,
    rad = sum_k ctb_k * prod_{j<=k} f_j,
inclusive at the emitting bounce so that an image-textured light gets its
own texel. The turbulence of noise texels runs on kernel K8
(`perlin_turb.py`). With `emit_deferred=True` the records are returned too
(the backward's residuals).

The single pass of a sphere-only scene (K1, K1-emit, K6a there) is the
kernel's `sphere_kernel`: persistent warps claim lanes from a per-launch
counter and refill a slot as soon as its lane dies, each thread carrying
SPHERE_RAYS lane slots (one) against the packed sphere rows
(`build_sphere_rows`) in shared memory; its records are views of one
32-byte row a record. The single pass of a scene with media (K5, K5-emit,
and K6a's records there) is the kernel's `media_kernel`: the same
persistent warps, one lane slot a thread, over the volume table, the
packed sphere rows and the packed planar rows read from global memory. So
is a phased launch of a scene with media at one lane a ray (G = 1), with
phase I/O: its slots refill as lanes die or spend the phase's bounces.
`fused_kernel` names the kernel a launch takes; `claim_order` is the plain
twin of both persistent kernels' work order, for the CPU tests.

None of the JAX kernel's TPU layout is carried over (K-split bf16 tables,
one-hot MXU gathers, sublane planes, chunk lists and their AABB culling,
`p_stream`, peeled primaries, block tiling, power-of-two phase buckets): a
thread carries a lane and reads table rows by index.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_weekend_tpu_torch import integrator, replay
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.sphere import sphere_uv
from raytracer_weekend_tpu_torch.scene.data import (
    VOL_BOX, SceneData, SceneStatic, without_trees)
from raytracer_weekend_tpu_torch.textures import TextureTable
from raytracer_weekend_tpu_torch.utils import metrics

# Launches of the CUDA kernel in this process, without and with the winner
# codes, those whose scene has planar primitives (the planar branch, with or
# without codes), those in deferred-texture mode (K6a, with or without
# codes), those whose scene has media (K5), those with phase I/O (K6b) and,
# of these, those on `media_kernel`'s refilling warps. Only the launch in
# `_launch` adds to them. The sphere-only single pass (no planar rows, media
# or phases: K1, K1-emit, K6a on sphere scenes) is csrc/megakernel.cuh's
# `sphere_kernel`; which kernel every launch takes is `fused_kernel`'s.
LAUNCHES = 0
EMIT_LAUNCHES = 0
PLANAR_LAUNCHES = 0
DEFER_LAUNCHES = 0
VOL_LAUNCHES = 0
PHASE_LAUNCHES = 0
REFILL_LAUNCHES = 0

# Rows of the sphere table, in the order of `enum Row` in csrc/megakernel.cuh.
TABLE_ROWS = (
    "c0x", "c0y", "c0z", "dcx", "dcy", "dcz", "t0", "inv_dt", "dt", "r2",
    "radius", "mtype", "fuzz", "ior", "ttype",
    "c1r", "c1g", "c1b", "c2r", "c2g", "c2b", "tscale", "tid",
    "k0", "k1", "k2",
)
PAR_SIZE = 24
# The sphere-only single pass's packed rows (`build_sphere_rows`): three
# float4 a sphere, (c0, k0), (dc, k1), (t0, inv_dt, k2, 0); and its
# compile-time lane slots a thread, block and rows kept in shared memory
# (`kSphereRays`, `kSphereBlock`, `kSphereRowLimit` in csrc/megakernel.cuh).
SPHERE_ROW_COLS = ("c0x", "c0y", "c0z", "k0", "dcx", "dcy", "dcz", "k1",
                   "t0", "inv_dt", "k2", None)
SPHERE_RAYS, SPHERE_BLOCK, SPHERE_ROW_LIMIT = 1, 128, 1024
# Its deferred records: one 32-byte row per lane and bounce, ctb (3), abc
# (3), dcode's int32 bits, 0 (`RECORD_COLS` floats).
RECORD_COLS = 8
# The media single pass (`media_kernel`): threads a block, one lane slot
# each (`kMediaBlock` in csrc/megakernel.cuh).
MEDIA_BLOCK = 128
# Columns of a row of the volume table (`enum VCol`): the JAX
# `_build_vol_par` layout, then a valid flag.
VOL_COLS = (
    "isbox", "cx", "cy", "cz", "r2", "b0x", "b0y", "b0z", "b1x", "b1y", "b1z",
    "cos", "sin", "offx", "offy", "offz", "nid", "cr", "cg", "cb", "valid",
)
# The lane state between depth phases (`enum StateCol`): o, d, throughput,
# radiance, time, alive, segments.
STATE_SIZE = 15
# Bounces per phase of the depth-phased render.
PHASE_LEN = 10
DEEP_MIN_DEPTH = 16
# Lanes per ray a phased launch may take (`csrc/megakernel.cuh`: a group
# of G lanes of one warp carries one ray), and the kernel's block size.
GROUPS = (1, 2, 4, 8, 16, 32)
BLOCK = 128
# Dynamic shared memory of a launch with planar rows: two tiles of 512
# float4 plane rows (`kTileBytes`).
TILE_BYTES = 2 * 512 * 16
# The planar prefilter's margins (`plane_candidate` in the kernel).
CAND_LO, CAND_HI, CAND_TINY = 1.0 - 2.0**-20, 1.0 + 2.0**-20, 2.0**-100
# Rows of the planar table, in the order of `enum PRow` in csrc/megakernel.cuh.
# The shading rows (mtype .. tscale) sit at the sphere table's row numbers.
PLANAR_ROWS = (
    "nx", "ny", "nz", "k", "uax", "uay", "uaz", "ca", "ubx", "uby", "ubz",
    "mtype", "fuzz", "ior", "ttype",
    "c1r", "c1g", "c1b", "c2r", "c2g", "c2b", "tscale",
    "cb", "flag", "ns0x", "ns0y", "ns0z", "nsux", "nsuy", "nsuz",
    "nsvx", "nsvy", "nsvz", "tu0", "tuu", "tuv", "tv0", "tvu", "tvv", "tid",
)
assert PLANAR_ROWS[11:22] == TABLE_ROWS[11:22]


def fused_supported(static: SceneStatic, cfg: RenderConfig) -> bool:
    """The CUDA megakernel renders this (scene, config).

    Scenes of spheres and/or rects and triangles, with or without media,
    that the builder marks `fused_simple` (Lambertian/Metal/Dielectric/
    DiffuseLight materials over solid, checker, noise, image or, on planar
    primitives, uv-debug textures; media with solid isotropic albedos). The
    JAX kernel's 2,048-sphere, 128k-primitive and 8-medium caps came from
    TPU VMEM and an unrolled loop, and are not carried over.
    """
    return (static.fused_simple
            and static.n_spheres + static.n_rects + static.n_triangles > 0
            and cfg.width > 1 and cfg.height > 1)


def defers(static: SceneStatic) -> bool:
    """The fused render of this scene defers noise and image texels."""
    return bool(static.has_noise or static.has_image)


def fused_kernel(n_planar: int, n_volumes: int, phase: bool,
                 group: int | None = None) -> str:
    """The kernel of csrc/megakernel.cuh that a fused launch takes
    (`dispatch` in csrc/megakernel.cu): "sphere_kernel" for a single pass
    over spheres alone, "media_kernel" for a launch with media that is a
    single pass or a phased launch at `group` 1 (one lane a ray: its live
    lanes fill the card, and its slots refill), else "render_kernel" (a
    single pass with planar rows and no media, a phased launch without
    media, and every phased launch at G > 1). A phased launch states its
    group."""
    if phase and group is None:
        raise ValueError("a phased launch's kernel depends on its group")
    if n_volumes and (not phase or group == 1):
        return "media_kernel"
    if phase:
        return "render_kernel"
    return "render_kernel" if n_planar else "sphere_kernel"


def build_sphere_table(scene: SceneData) -> torch.Tensor:
    """(len(TABLE_ROWS), S) float32 SoA table on the scene's device.

    Material and texture fields are gathered per sphere, so the kernel reads
    one column per hit. The sphere test's static terms k0 = |c0|^2 - r^2,
    k1 = 2 c0.dc and k2 = |dc|^2 are computed in float64 from the float32
    rows and rounded once (k0 is exactly 0 for the radius-1000 ground).
    Padding rows get r2 = -inf and k0 = +inf and never hit.
    """
    sp, mt, tx = scene.spheres, scene.materials, scene.textures
    mat = sp.mat.long()
    tex = mt.tex[mat].long()
    dt = sp.t1 - sp.t0
    dc = sp.c1 - sp.c0
    r2 = torch.where(sp.valid, sp.radius * sp.radius, -torch.inf)
    c0d, dcd, rd = sp.c0.double(), dc.double(), sp.radius.double()
    k0 = torch.where(sp.valid, (c0d * c0d).sum(-1) - rd * rd, torch.inf)
    cols = {
        "c0x": sp.c0[:, 0], "c0y": sp.c0[:, 1], "c0z": sp.c0[:, 2],
        "dcx": dc[:, 0], "dcy": dc[:, 1], "dcz": dc[:, 2],
        "t0": sp.t0, "inv_dt": 1.0 / dt, "dt": dt, "r2": r2,
        "radius": sp.radius, "mtype": mt.mtype[mat].float(),
        "fuzz": mt.fuzz[mat], "ior": mt.ior[mat],
        "ttype": tx.ttype[tex].float(),
        "c1r": tx.color1[tex, 0], "c1g": tx.color1[tex, 1],
        "c1b": tx.color1[tex, 2],
        "c2r": tx.color2[tex, 0], "c2g": tx.color2[tex, 1],
        "c2b": tx.color2[tex, 2],
        "tscale": tx.scale[tex], "tid": tex,
        "k0": k0, "k1": 2.0 * (c0d * dcd).sum(-1), "k2": (dcd * dcd).sum(-1),
    }
    return torch.stack([cols[r].to(torch.float32) for r in TABLE_ROWS])


def build_sphere_rows(tab: torch.Tensor) -> torch.Tensor:
    """The sphere-only kernel's packed rows from `build_sphere_table`'s
    (len(TABLE_ROWS), S) table -> (S, 12) float32, contiguous: the table's
    values of SPHERE_ROW_COLS, 0 in the last column."""
    cols = [torch.zeros_like(tab[0]) if c is None else tab[TABLE_ROWS.index(c)]
            for c in SPHERE_ROW_COLS]
    return torch.stack(cols, dim=1).contiguous()


def build_vol_table(scene: SceneData) -> torch.Tensor:
    """(V, len(VOL_COLS)) float32 table of the media on the scene's device:
    the JAX `_build_vol_par` rows (boundary, Y-rotation, translation,
    -1/density, the isotropic albedo, a solid color), plus valid = 1/0.
    Invalid rows also get r2 = -1e30 and a [1, 0] slab, as in JAX; the
    kernel skips them by the flag."""
    vol = scene.volumes
    col = scene.textures.color1[scene.materials.tex[vol.mat.long()].long()]
    valid = vol.valid
    r2 = torch.where(valid, vol.radius * vol.radius, -1e30)
    bmin = torch.where(valid[:, None], vol.bmin, 1.0)
    bmax = torch.where(valid[:, None], vol.bmax, 0.0)
    cols = [(vol.vtype == VOL_BOX).float(), *vol.center.unbind(1), r2,
            *bmin.unbind(1), *bmax.unbind(1), vol.cos_t, vol.sin_t,
            *vol.offset.unbind(1), vol.neg_inv_density, *col.unbind(1),
            valid.float()]
    return torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous()


def build_planar_table(scene: SceneData, static: SceneStatic) -> torch.Tensor:
    """(len(PLANAR_ROWS), R) float32 SoA table on the scene's device, R =
    n_rects + n_triangles, rects first (the unified planar index).

    The coefficients of `replay._pack_planar`, which are the JAX
    `_build_planar_tables`' without its K-split, sublane stacking or chunks:
    t = (k - n.o)/(n.d), u = ua.p + ca, v = ub.p + cb, shading normal
    ns0 + u*nsu + v*nsv, uv-debug coordinates (tu|tv).(1, u, v), and the
    material and texture rows gathered per primitive; plus the flag row (0
    rect, 1 triangle). A degenerate triangle has n = 0 and an invalid row
    gets n = 0, k = 0, so the kernel's t is 0/0 = NaN and never hits.
    """
    cols = dict(zip(replay.PLANAR_COLS, replay._pack_planar(scene, static).T))
    valid, flag = [], []
    for n, fam, f in ((static.n_rects, scene.rects, 0.0),
                      (static.n_triangles, scene.triangles, 1.0)):
        if n:
            valid.append(fam.valid)
            flag.append(torch.full_like(fam.valid, f, dtype=torch.float32))
    valid = torch.cat(valid)
    cols["flag"] = torch.cat(flag)
    for key in ("nx", "ny", "nz", "k"):
        cols[key] = torch.where(valid, cols[key], 0.0)
    return torch.stack([cols[r].to(torch.float32) for r in PLANAR_ROWS])


def build_planar_test(ptab: torch.Tensor) -> torch.Tensor:
    """The kernel's packed planar test rows from `build_planar_table`'s
    (len(PLANAR_ROWS), R) table -> (16 R,) float32: R rows (nx, ny, nz, k)
    for the plane test, staged through shared memory, then R rows of
    (uax, uay, uaz, ca, ubx, uby, ubz, cb, flag, 0, 0, 0) for the in-plane
    test, read for candidates only. Each row is a multiple of 16 bytes."""
    def rows(*names):
        return torch.stack([ptab[PLANAR_ROWS.index(n)] for n in names], 1)

    zero = torch.zeros_like(ptab[0])
    inside = torch.cat([rows("uax", "uay", "uaz", "ca", "ubx", "uby", "ubz",
                             "cb", "flag"),
                        torch.stack([zero, zero, zero], 1)], 1)
    return torch.cat([rows("nx", "ny", "nz", "k").reshape(-1),
                      inside.reshape(-1)]).contiguous()


def pack_par(scene: SceneData, cam: Camera) -> torch.Tensor:
    """Camera + background as 24 floats (the JAX `_pack_par` layout)."""
    dev = scene.device
    parts = [cam.origin, cam.lower_left, cam.horizontal, cam.vertical, cam.u,
             cam.v, torch.stack([cam.lens_radius, cam.time0,
                                 cam.time1 - cam.time0])]
    return torch.cat([p.to(dev, torch.float32) for p in parts]
                     + [scene.background.to(torch.float32)])


def render_fused_reference(scene: SceneData, cfg: RenderConfig, cam: Camera,
                           lane_start: int, n_chunk: int, seed, *,
                           static: SceneStatic, emit_paths: bool = False,
                           emit_deferred: bool = False):
    """Plain torch version of `render_fused`: (radiance (n,3) f32,
    segments (n,) int32), with `emit_paths` the winner codes (n, D) int32,
    and with `emit_deferred` (a deferring scene) the records ctb (n, D, 3),
    abc (n, D, 3) and dcode (n, D) int32. A deferring scene's radiance is
    their combine, with the plain turbulence."""
    out = records_reference(scene, cfg, cam, lane_start, n_chunk, seed,
                            static=static, emit_paths=emit_paths)
    return _finish(scene, static, out, emit_deferred, _turbulence_plain)


def records_reference(scene: SceneData, cfg: RenderConfig, cam: Camera,
                      lane_start: int, n_chunk: int, seed, *,
                      static: SceneStatic, emit_paths: bool = False):
    """Plain torch version of `render_fused_records` (the staged path,
    `integrator.trace_lanes`, with the plain brute-force closest hit: the
    kernel tests every row and never reads a tree)."""
    cfg = dataclasses.replace(cfg, use_pallas=False)
    ids = lane_start + torch.arange(n_chunk, dtype=torch.int64,
                                    device=scene.device)
    o, d, time, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
    return integrator.trace_lanes(*without_trees(scene, static), cfg, o, d,
                                  time, ray_id, seed, emit_paths=emit_paths,
                                  emit_deferred=defers(static))


def _finish(scene, static, out, emit_deferred, noise_fn=None):
    """(rad, seg, [codes], [ctb, abc, dcode]) -> the render's outputs: a
    deferring scene's radiance is the combine of its records, which are
    returned only with `emit_deferred`."""
    if not defers(static):
        return out
    rad, seg, *rest = out
    ctb, abc, dcode = rest[-3:]
    count_records(dcode)
    with metrics.span("rtw.diff.combine"):
        rad = combine(scene, static, ctb, abc, dcode, noise_fn)
    return ((rad, seg) + tuple(rest[:-3])
            + ((ctb, abc, dcode) if emit_deferred else ()))


def count_records(dcode: torch.Tensor) -> None:
    """The counters of a deferring launch's records: `record_slots` (lanes
    x bounces) and `live_records` (dcode != 0, summed on the device)."""
    if metrics.on():
        metrics.count("record_slots", dcode.numel())
        metrics.count("live_records", dcode != 0)


def _turbulence_k8(grad, perm, p, live):
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb

    return perlin_turb.turbulence(grad, perm, p, 7, live)


def _turbulence_plain(grad, perm, p, live):
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb

    return perlin_turb.turbulence_reference(grad, perm, p, 7, live)


def combine(scene: SceneData, static: SceneStatic, ctb, abc, dcode,
            noise_fn=None):
    """The deferred combine the scene takes -> radiance (n, 3):
    `combine_deferred_single` when `static.defer_single_hit`, else for a
    scene without noise `image_combine.combine_images` (its kernel on a
    card), else `combine_deferred`. `noise_fn` as
    `textures.texture_value`'s, by default K8 (forward only; its plain
    version on the CPU)."""
    if static.defer_single_hit:
        return combine_deferred_single(scene.textures, ctb, abc, dcode)
    if not static.has_noise:
        from raytracer_weekend_tpu_torch.ops.cuda import image_combine

        return image_combine.combine_images(scene.textures, ctb, abc, dcode)
    return combine_deferred(scene.textures, ctb, abc, dcode,
                            has_noise=static.has_noise,
                            has_image=static.has_image,
                            noise_fn=noise_fn or _turbulence_k8)


def combine_deferred(textures: TextureTable, ctb, abc, dcode, *,
                     has_noise: bool, has_image: bool, noise_fn=None,
                     init=None, return_factors: bool = False):
    """rad = sum_k ctb_k * prod_{j<=k} f_k over the deferred texels -> (n,3).

    The JAX `_combine_deferred`: the texel f_k of record k is
    `textures.texture_value` at texture |dcode| - 1, with the spherical UV
    of abc for a sphere's image texel (dcode > 0), abc's (u, v) for a planar
    one and abc as the point for noise; f_k = 1 where dcode is 0. The
    product is inclusive at the emitting bounce. Differentiable in the
    texture table, ctb and abc (at records where dcode is 0, abc must be a
    regular point for the spherical UV's Jacobian: the caller's anchor).

    With `return_factors` it returns (rad, F), F (n, 3) the running factor
    product after the last record (the JAX `return_factors`), and `init`
    = (rad, F) of the records before these continues that sum and product
    where they stopped: the depth-phased render chains its phases so, and
    gets the single pass's sums operation for operation.
    """
    f = deferred_texels(textures, abc, dcode, has_noise=has_noise,
                        has_image=has_image, noise_fn=noise_fn)
    # The running product over the D bounces as D products: on a card,
    # torch's scan along a short innermost dimension runs one row per
    # thread and took longer than the whole forward kernel.
    rad, cp = (None, None) if init is None else init
    for k in range(f.shape[1]):
        cp = f[:, k] if cp is None else cp * f[:, k]
        term = ctb[:, k] * cp
        rad = term if rad is None else rad + term
    return (rad, cp) if return_factors else rad


def deferred_texels(textures: TextureTable, abc, dcode, *, has_noise: bool,
                    has_image: bool, noise_fn=None):
    """The texel f_k (n, D, 3) of each deferred record, as
    `combine_deferred` takes it: `textures.texture_value` at texture
    |dcode| - 1, with the spherical UV of abc for a sphere's image texel
    (dcode > 0), abc's (u, v) for a planar one and abc as the point for
    noise; 1 where dcode is 0."""
    absid = dcode.abs()
    live = absid > 0
    texid = torch.clamp_min(absid - 1, 0)
    u, v = abc[..., 0], abc[..., 1]        # planar image texels: (u, v)
    if has_image:
        is_img = textures.ttype[texid.long()] == tex_mod.IMAGE
        u_s, v_s = sphere_uv(abc)
        sphere_img = is_img & (dcode > 0)
        u = torch.where(sphere_img, u_s, u)
        v = torch.where(sphere_img, v_s, v)
    f = tex_mod.texture_value(textures, texid, u, v, abc, has_noise=has_noise,
                              has_image=has_image, noise_fn=noise_fn,
                              live=live)
    return torch.where(live[..., None], f, 1.0)


def combine_deferred_single(textures: TextureTable, ctb, abc, dcode):
    """The single-deferred-hit combine (`SceneStatic.defer_single_hit`: one
    image sphere that a path meets at most once) -> (n, 3):
    rad = sum_{k<k1} ctb_k + f * sum_{k>=k1} ctb_k, one texel per lane.
    Lanes without a record fetch at the anchor abc = 0.5 and use f = 1."""
    live = dcode > 0
    # after[:, k]: the lane's first record k1 is at or before bounce k (a
    # running or over the D bounces; see combine_deferred on scans).
    seen, after = None, []
    for k in range(live.shape[1]):
        seen = live[:, k] if seen is None else seen | live[:, k]
        after.append(seen)
    after = torch.stack(after, dim=1)
    first = live & ~torch.cat([torch.zeros_like(after[:, :1]),
                               after[:, :-1]], dim=1)
    any_l = after[:, -1]
    texid = torch.clamp_min((dcode * first).sum(dim=1) - 1, 0)
    rec = (abc * first[..., None]).sum(dim=1)
    rec = torch.where(any_l[:, None], rec, 0.5)
    u, v = sphere_uv(rec)
    f = tex_mod.texture_value(textures, texid, u, v, rec, has_noise=False,
                              has_image=True)
    f = torch.where(any_l[:, None], f, 1.0)
    after = after.to(ctb.dtype)[..., None]
    pre = torch.sum(ctb * (1.0 - after), dim=1)
    post = torch.sum(ctb * after, dim=1)
    return pre + f * post


def _check(t: torch.Tensor, dtype, shape, device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"kernel argument: want {dtype} {tuple(shape)} "
                         f"contiguous on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def render_fused(scene: SceneData, cfg: RenderConfig, cam: Camera,
                 lane_start: int, n_chunk: int, seed, *,
                 static: SceneStatic, emit_paths: bool = False,
                 emit_deferred: bool = False, deep: bool | None = None):
    """Render lanes [lane_start, lane_start + n_chunk).

    Returns (radiance (n_chunk, 3) f32, segments (n_chunk,) int32) on the
    scene's device, with `emit_paths` the winner codes (n_chunk, max_depth)
    int32, and with `emit_deferred` (a scene with noise or image textures)
    the deferred-texture records ctb (n_chunk, max_depth, 3) f32, abc
    (n_chunk, max_depth, 3) f32 and dcode (n_chunk, max_depth) int32. The
    CPU runs the plain version; CUDA runs the kernel, and for a deferring
    scene the combine with K8. `deep` (by default: a whole frame at
    max_depth >= 16, without codes or records, as JAX `render_fused`
    chooses) renders in depth phases, `render_fused_deep`: the same lanes
    bit for bit.
    """
    if emit_deferred and not defers(static):
        raise ValueError("emit_deferred needs a scene with noise or image "
                         "textures")
    if deep is None:
        deep = (cfg.max_depth >= DEEP_MIN_DEPTH and int(lane_start) == 0
                and int(n_chunk) == cfg.n_rays and not emit_paths
                and not emit_deferred)
    if deep:
        if emit_paths or emit_deferred:
            raise ValueError("the depth-phased render emits no codes or "
                             "records")
        return render_fused_deep(scene, cfg, cam, lane_start, n_chunk, seed,
                                 static=static)
    out = render_fused_records(scene, cfg, cam, lane_start, n_chunk, seed,
                               static=static, emit_paths=emit_paths)
    return _finish(scene, static, out, emit_deferred)


def render_fused_records(scene: SceneData, cfg: RenderConfig, cam: Camera,
                         lane_start: int, n_chunk: int, seed, *,
                         static: SceneStatic, emit_paths: bool = False):
    """The fused kernel's own outputs, before any combine: (radiance,
    segments), with `emit_paths` the codes, and for a deferring scene the
    records (ctb, abc, dcode), the radiance then lacking the deferred
    texels. CUDA launches the kernel (K1/K3/K5, K6a when deferring); the
    CPU runs `records_reference`."""
    if scene.device.type == "cpu":
        return records_reference(scene, cfg, cam, lane_start, n_chunk, seed,
                                 static=static, emit_paths=emit_paths)
    return _launch(scene, cfg, cam, lane_start, n_chunk, seed, static,
                   emit_paths=emit_paths)


def build_tables(scene: SceneData, static: SceneStatic, cam: Camera):
    """(sphere table or None, planar table or None, its packed test rows or
    None, volume table or None, camera parameters, the sphere table's packed
    rows or None): what a launch reads (the packed rows: a sphere-only
    single pass, `sphere_kernel`)."""
    with metrics.span("rtw.fused.tables"):
        ptab = (build_planar_table(scene, static)
                if static.n_rects + static.n_triangles else None)
        tab = build_sphere_table(scene) if static.n_spheres else None
        return (tab, ptab, None if ptab is None else build_planar_test(ptab),
                build_vol_table(scene) if static.n_volumes else None,
                pack_par(scene, cam),
                None if tab is None else build_sphere_rows(tab))


def _launch(scene: SceneData, cfg: RenderConfig, cam: Camera,
            lane_start: int, n_chunk: int, seed, static: SceneStatic, *,
            emit_paths: bool = False, phase: bool = False, state=None,
            lanes=None, d0: int = 0, tables=None, group: int = 1,
            resident: bool | None = None, kernel: str | None = None):
    """One launch of the CUDA kernel -> (rad, seg, [codes], [ctb, abc,
    dcode], [state]). With `phase` it runs bounces d0 .. d0 + max_depth - 1
    with `group` lanes per ray (a power of two up to 32) and returns the
    lanes' state (n, 15) last; with `state` (n, 15) and `lanes` (n,) int32
    global lane ids it resumes those lanes. A sphere-only single pass (no
    planar rows, media or phase) keeps its packed rows in shared memory up to
    SPHERE_ROW_LIMIT rows; `resident` True or False forces either path (a
    test hook: the two give the same bits), and its records are views of
    one (n, D, RECORD_COLS) buffer. A single pass with media is
    `media_kernel`'s, and so is a phased launch with media at `group` 1:
    `kernel` None takes `fused_kernel`'s choice, and a phased launch may
    name "render_kernel" instead (the caller's choice, as `_render_deep`'s
    test hook makes it: the two give the same bits). Raises off CUDA,
    outside `fused_supported`, and if the build or launch fails."""
    global LAUNCHES, EMIT_LAUNCHES, PLANAR_LAUNCHES, DEFER_LAUNCHES
    global VOL_LAUNCHES, PHASE_LAUNCHES, REFILL_LAUNCHES
    device = scene.device
    if device.type != "cuda":
        raise NotImplementedError(f"no fused kernel on {device}")
    if not fused_supported(static, cfg):
        raise NotImplementedError(f"the CUDA megakernel does not cover this "
                                  f"scene/config: {static}, {cfg}")
    n_chunk = int(n_chunk)
    lane_start = int(lane_start)
    if state is None and (n_chunk < 0 or lane_start < 0
                          or lane_start + n_chunk > cfg.n_rays):
        raise ValueError(f"lane window [{lane_start}, {lane_start + n_chunk}) "
                         f"outside [0, {cfg.n_rays})")
    if n_chunk >= 2**31:
        raise ValueError("n_chunk must fit in int32")
    if (state is not None or d0 or group != 1) and not phase:
        raise ValueError("a state in, d0 or a group needs phase=True")
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group}")

    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    tab, ptab, ptest, vtab, par, srows = (tables
                                          or build_tables(scene, static, cam))
    n_spheres = 0 if tab is None else tab.shape[1]
    n_planar = 0 if ptab is None else ptab.shape[1]
    n_vol = 0 if vtab is None else vtab.shape[0]
    if n_spheres:
        _check(tab, torch.float32, (len(TABLE_ROWS), n_spheres), device)
    if n_planar:
        _check(ptab, torch.float32, (len(PLANAR_ROWS), n_planar), device)
        _check(ptest, torch.float32, (16 * n_planar,), device)
    if n_vol:
        _check(vtab, torch.float32, (n_vol, len(VOL_COLS)), device)
    _check(par, torch.float32, (PAR_SIZE,), device)
    routed = fused_kernel(n_planar, n_vol, phase, group)
    kernel = kernel or routed
    if kernel != routed and not (phase and kernel == "render_kernel"):
        raise ValueError(f"this launch takes {routed}, not {kernel}")
    spheres, media = kernel == "sphere_kernel", kernel == "media_kernel"
    if resident is not None and not spheres:
        raise ValueError("resident applies to the sphere-only single pass")
    if (spheres or media) and n_spheres:
        _check(srows, torch.float32, (n_spheres, len(SPHERE_ROW_COLS)),
               device)
    if state is not None:
        _check(state, torch.float32, (n_chunk, STATE_SIZE), device)
        _check(lanes, torch.int32, (n_chunk,), device)
    rad = torch.empty((n_chunk, 3), dtype=torch.float32, device=device)
    seg = torch.empty((n_chunk,), dtype=torch.int32, device=device)
    D = cfg.max_depth
    codes = (torch.empty((n_chunk, D), dtype=torch.int32, device=device)
             if emit_paths else None)
    recs, rec_rows = [None] * 3, None
    if defers(static) and spheres:
        rec_rows = torch.empty((n_chunk, D, RECORD_COLS), dtype=torch.float32,
                               device=device)
        recs = [rec_rows[..., 0:3], rec_rows[..., 3:6],
                rec_rows.view(torch.int32)[..., 6]]
    elif defers(static):
        recs = [torch.empty((n_chunk, D, 3), dtype=torch.float32,
                            device=device),
                torch.empty((n_chunk, D, 3), dtype=torch.float32,
                            device=device),
                torch.empty((n_chunk, D), dtype=torch.int32, device=device)]
    st_out = (torch.empty((n_chunk, STATE_SIZE), dtype=torch.float32,
                          device=device) if phase else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        # The persistent kernels' lane counter, zeroed on this stream.
        nxt = (torch.zeros((1,), dtype=torch.int32, device=device)
               if spheres or media else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_render_fused(
            ptr(tab), n_spheres, ptr(ptab), ptr(ptest), n_planar, ptr(vtab),
            n_vol, par.data_ptr(), lane_start, n_chunk, cfg.width,
            cfg.height, cfg.samples_per_pixel, D, int(d0), int(group),
            int(phase and media), float(cfg.t_min),
            int(seed) & 0xFFFFFFFF, int(cfg.use_log10_volume_sampling),
            rad.data_ptr(), seg.data_ptr(), ptr(codes),
            *((None,) * 3 if spheres else map(ptr, recs)),
            ptr(state), ptr(lanes), ptr(st_out),
            ptr(srows if spheres or (media and n_spheres) else None),
            -1 if resident is None else int(bool(resident)), ptr(nxt),
            ptr(rec_rows), stream)
    _build.check(lib, err, "rtw_render_fused launch")
    if n_planar:
        PLANAR_LAUNCHES += 1
    if recs[0] is not None:
        DEFER_LAUNCHES += 1
    if n_vol:
        VOL_LAUNCHES += 1
    if phase:
        PHASE_LAUNCHES += 1
    if phase and media:
        REFILL_LAUNCHES += 1
    if emit_paths:
        EMIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return ((rad, seg) + ((codes,) if emit_paths else ())
            + (tuple(recs) if recs[0] is not None else ())
            + ((st_out,) if phase else ()))


def phase_reference(scene: SceneData, cfg: RenderConfig, cam: Camera,
                    lanes: torch.Tensor, state, d0: int, seed, *,
                    static: SceneStatic):
    """Plain torch version of one phased launch: bounces d0 .. d0 +
    max_depth - 1 of the lanes with global ids `lanes`, from their primary
    rays (`state` None) or from `state` (n, 15) -> (rad, seg, [ctb, abc,
    dcode], state (n, 15)), `integrator.trace_lanes` with d0 and a carry
    and the plain brute-force closest hit."""
    cfg = dataclasses.replace(cfg, use_pallas=False)
    if state is None:
        o, d, time, ray_id = integrator._pixel_rays(cam, cfg, lanes.long(),
                                                    seed)
        carry = None
    else:
        ray_id = lanes.long() & 0xFFFFFFFF
        o, d, time = state[:, 0:3], state[:, 3:6], state[:, 12]
        carry = (state[:, 6:9], state[:, 9:12], state[:, 13] > 0.0,
                 state[:, 14].to(torch.int32))
    *out, fin = integrator.trace_lanes(
        *without_trees(scene, static), cfg, o, d, time, ray_id, seed,
        emit_deferred=defers(static), d0=d0, carry=carry, return_carry=True)
    o, d, tp, rad, alive, seg = fin
    st = torch.cat([o, d, tp, rad, time[:, None],
                    alive.to(torch.float32)[:, None],
                    seg.to(torch.float32)[:, None]], dim=1)
    return (*out, st)


def render_fused_deep(scene: SceneData, cfg: RenderConfig, cam: Camera,
                      lane_start: int, n_chunk: int, seed, *,
                      static: SceneStatic, phase_len: int = PHASE_LEN,
                      plain: bool = False, live_counts: list | None = None):
    """Depth-phased render with compaction between phases -> (radiance
    (n, 3), segments (n,)), the lanes of `render_fused(..., deep=False)`
    bit for bit.

    The JAX `render_fused_deep`: the depth range splits into phases of
    `phase_len` bounces; after each the kernel (K6b: the phase I/O of
    csrc/megakernel.cuh) has written every lane's state, the host counts the
    survivors (one sync per phase; appended to `live_counts` when given),
    gathers them in order and the next phase resumes only those. A lane's
    random numbers key on its global id and the absolute depth, so its path
    does not depend on its phase or batch position. Each phase's totals are
    scattered back to the lanes' original slots. Deferred texels chain
    across phases: the combine continues each lane's running sum and factor
    product where the last phase left them (`combine_deferred(init=...,
    return_factors=True)`, or for a scene without noise
    `image_combine.combine_images`, its kernel on a card), so the sums are
    the single pass's, operation for operation. The JAX power-of-two
    bucket and its `min_bucket` only spared XLA recompiles: here each
    phase runs on exactly the live lanes.
    Each launch runs a group of G lanes per ray (`phase_group`: the
    smallest G for which the live lanes fill the card's resident threads),
    so that the tail of few long paths still fills the card. A launch at
    G = 1 of a scene with media runs on `media_kernel`'s persistent warps,
    which refill a lane slot as soon as its lane ends (`fused_kernel`).
    On the CPU, or with `plain`, each phase is `phase_reference`.
    """
    return _render_deep(scene, cfg, cam, lane_start, n_chunk, seed,
                        static=static, phase_len=phase_len, plain=plain,
                        live_counts=live_counts)


def _render_deep(scene: SceneData, cfg: RenderConfig, cam: Camera,
                 lane_start: int, n_chunk: int, seed, *, static: SceneStatic,
                 phase_len: int = PHASE_LEN, plain: bool = False,
                 live_counts: list | None = None, group: int | None = None,
                 phases: list | None = None, refill: bool = True):
    """`render_fused_deep`, with `group` forcing every launch's lanes per
    ray, `refill` False keeping every launch on render_kernel (a test hook:
    the same bits), and `phases` (a list) getting one dict per launch: its
    d0, lanes, group, kernel, config and inputs (state and lane ids, None
    for the first), from which the same launch can be run again."""
    from raytracer_weekend_tpu_torch.ops.cuda import image_combine

    with metrics.span("rtw.fused.deep"):
        dev = scene.device
        plain = plain or dev.type == "cpu"
        D, n = cfg.max_depth, int(n_chunk)
        defer = defers(static)
        # The single pass's turbulence: K8 on the card, its plain twin here.
        noise_fn = _turbulence_plain if plain else _turbulence_k8
        tables = None if plain else build_tables(scene, static, cam)
        resident = (None if plain or group is not None
                    else resident_threads(static, dev))
        n_planar = static.n_rects + static.n_triangles
        rad_bank = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        seg_bank = torch.zeros((n,), dtype=torch.int32, device=dev)
        slots = torch.arange(n, device=dev)      # bank slot of each lane
        lanes = (int(lane_start) + slots).to(torch.int32)
        state, acc = None, None
        d0 = 0
        while d0 < D:
            cfg_p = dataclasses.replace(cfg,
                                        max_depth=min(phase_len, D - d0))
            metrics.count("phase_lane_bounces",
                          lanes.shape[0] * cfg_p.max_depth)
            if plain:
                out = phase_reference(scene, cfg_p, cam, lanes, state, d0,
                                      seed, static=static)
            else:
                g = group or phase_group(lanes.shape[0], resident)
                kernel = (fused_kernel(n_planar, static.n_volumes, True, g)
                          if refill else "render_kernel")
                if kernel == "media_kernel":
                    metrics.count("refill_lane_bounces",
                                  lanes.shape[0] * cfg_p.max_depth)
                ids = None if state is None else lanes
                if phases is not None:
                    phases.append(dict(d0=d0, lanes=lanes.shape[0], group=g,
                                       kernel=kernel, cfg=cfg_p, state=state,
                                       ids=ids))
                out = _launch(scene, cfg_p, cam, lane_start,
                              lanes.shape[0], seed, static, phase=True,
                              state=state, lanes=ids, d0=d0, tables=tables,
                              group=g, kernel=kernel)
            rad, seg, *recs, st = out
            if defer:
                count_records(recs[2])
                if static.has_noise:
                    acc = combine_deferred(scene.textures, *recs,
                                           has_noise=True,
                                           has_image=static.has_image,
                                           noise_fn=noise_fn, init=acc,
                                           return_factors=True)
                else:
                    acc = image_combine.combine_images(
                        scene.textures, *recs, init=acc, return_factors=True)
                rad = acc[0]
            rad_bank[slots] = rad
            seg_bank[slots] = seg
            d0 += cfg_p.max_depth
            if d0 >= D:
                break
            alive = st[:, 13] > 0.0
            with metrics.span("rtw.deep.sync"):  # one host sync a phase
                live = int(alive.sum())
            if live_counts is not None:
                live_counts.append(live)
            if live == 0:
                break
            if live < st.shape[0]:
                keep = torch.nonzero(alive).squeeze(1)
                st, slots, lanes = st[keep], slots[keep], lanes[keep]
                if acc is not None:
                    acc = (acc[0][keep], acc[1][keep])
            state = st.contiguous()
        return rad_bank, seg_bank


_RESIDENT: dict = {}


def resident_blocks(static: SceneStatic, device: torch.device,
                    phase: bool = True) -> int:
    """Blocks an SM keeps resident for the scene's launch without codes
    (phased by default) at its registers and shared memory:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor. Blocks of BLOCK threads,
    or of SPHERE_BLOCK for a sphere-only single pass (spheres, no planar
    rows or media, not phased: `sphere_kernel`, which launches that many
    blocks on each SM; its rows' shared memory counts from the real
    n_spheres), or of MEDIA_BLOCK for a single pass with media
    (`media_kernel`, no shared memory)."""
    import ctypes

    from raytracer_weekend_tpu_torch.ops.cuda import _build

    device = torch.device(device)
    key = (static.n_spheres, static.n_rects + static.n_triangles,
           static.n_volumes, defers(static), phase, device)
    if key not in _RESIDENT:
        lib = _build.load_library()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.rtw_render_occupancy(*map(int, key[:5]),
                                           ctypes.byref(blocks))
        _build.check(lib, err, "rtw_render_occupancy")
        if blocks.value < 1:
            raise RuntimeError("the render kernel fits no block on an SM of "
                               f"{device}")
        _RESIDENT[key] = blocks.value
    return _RESIDENT[key]


def resident_threads(static: SceneStatic, device: torch.device) -> int:
    """Threads the card keeps resident for the scene's phased launch on
    render_kernel, against which `phase_group` sets each phase's lanes a
    ray: `resident_blocks` x SMs x BLOCK."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return resident_blocks(static, device) * sms * BLOCK


def phase_group(live: int, resident: int) -> int:
    """The smallest G of GROUPS with live * G >= resident, else the
    largest: lanes per ray for a phase of `live` lanes."""
    for g in GROUPS:
        if live * g >= resident:
            return g
    return GROUPS[-1]


def claim_order(segments, warps: int, rays: int = SPHERE_RAYS,
                seed: int = 0):
    """Plain twin of the work order of `sphere_kernel` and (with rays=1,
    its one lane slot a thread) `media_kernel` over a window whose lane i
    runs segments[i] bounces (in a phased launch, the bounces it runs in
    the phase: at most the phase's length) -> (order (n,) int64: the lanes
    in the order they were claimed; owner (n, 3) int64: the warp, thread
    and slot that ran each lane).

    `warps` warps of 32 threads, `rays` lane slots a thread, take turns in
    a random order each round (`seed`), as resident warps interleave on the
    card. A warp's turn: while the window may hold lanes, it claims one for
    each empty slot from a shared counter (one atomicAdd for the warp; the
    slots in ballot order, slot-major, then by thread), a claim past the
    window leaving the slot empty; then each live slot runs one bounce, and
    a lane whose last bounce that was frees its slot. A warp leaves when the
    window is spent and its slots are empty."""
    segs = [int(x) for x in segments]
    n = len(segs)
    gen = torch.Generator().manual_seed(seed)
    lane = [[[-1] * rays for _ in range(32)] for _ in range(warps)]
    left = [[[0] * rays for _ in range(32)] for _ in range(warps)]
    more = [True] * warps
    active = list(range(warps))
    order, owner = [], [None] * n
    nxt = 0
    while active:
        for w in [active[i] for i in torch.randperm(len(active),
                                                    generator=gen)]:
            if more[w]:
                empty = [[t for t in range(32) if lane[w][t][r] < 0]
                         for r in range(rays)]
                total = sum(map(len, empty))
                if total:
                    slot, nxt = nxt, nxt + total
                    for r in range(rays):
                        for rank, t in enumerate(empty[r]):
                            i = slot + rank
                            if i < n:
                                lane[w][t][r], left[w][t][r] = i, segs[i]
                                order.append(i)
                                owner[i] = (w, t, r)
                        slot += len(empty[r])
                    more[w] = slot < n
            for t in range(32):
                for r in range(rays):
                    if lane[w][t][r] >= 0:
                        left[w][t][r] -= 1
                        if left[w][t][r] <= 0:
                            lane[w][t][r] = -1
            if not more[w] and all(x < 0 for th in lane[w] for x in th):
                active.remove(w)
    return (torch.tensor(order, dtype=torch.int64),
            torch.tensor(owner, dtype=torch.int64).reshape(n, 3))


def plane_candidate_plain(num: torch.Tensor, den: torch.Tensor,
                          t_min: float, best: torch.Tensor) -> torch.Tensor:
    """The kernel's division-free planar prefilter on float32 CPU tensors
    (each product rounded to nearest, subnormals kept: the kernel's `_rn`
    bits) -> bool. A superset of RN(num / den) >= t_min && < best for
    0 < t_min <= best; see `plane_candidate` in csrc/megakernel.cuh."""
    f32 = torch.float32
    num, den, best = (torch.as_tensor(x, dtype=f32) for x in (num, den, best))
    tm = torch.tensor(t_min, dtype=f32)
    lo_m, hi_m, tiny = (torch.tensor(x, dtype=f32)
                        for x in (CAND_LO, CAND_HI, CAND_TINY))
    dp = den.abs()
    np_ = torch.where(den < 0, -num, num)
    lo = (dp * tm) * lo_m
    hi = (dp * best) * hi_m
    return ((np_ > 0) & (dp > 0)
            & ((np_ >= lo) | (lo < tiny) | (lo == torch.inf))
            & ((np_ < hi) | (hi < tiny)))


def plane_candidate_device(num: torch.Tensor, den: torch.Tensor,
                           best: torch.Tensor, t_min: float) -> torch.Tensor:
    """The kernel's `plane_candidate` on CUDA float32 tensors -> (n,) bool.
    A probe of its superset property; not on the render path and not
    counted in LAUNCHES."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    n = num.numel()
    for x in (num, den, best):
        if (not x.is_cuda or x.dtype != torch.float32 or x.numel() != n
                or not x.is_contiguous()):
            raise ValueError("plane_candidate_device takes contiguous "
                             "float32 CUDA tensors of one length")
    out = torch.empty((n,), dtype=torch.int32, device=num.device)
    lib = _build.load_library()
    with torch.cuda.device(num.device):
        stream = torch.cuda.current_stream(num.device).cuda_stream
        err = lib.rtw_plane_candidate(num.data_ptr(), den.data_ptr(),
                                      best.data_ptr(), n, float(t_min),
                                      out.data_ptr(), stream)
    _build.check(lib, err, "rtw_plane_candidate launch")
    return out.bool()


def closest_hit_grouped(tab, ptab, o, d, time, t_min: float,
                        group: int = 1):
    """Plain twin of the phased kernel's closest hit with `group` lanes per
    ray, over `build_sphere_table` / `build_planar_table` tables (either
    None) -> (t (B,) f32, +inf for none; family (B,) int64: 0 sphere, 1
    planar, 2 none; index (B,) int64, -1 for none; u, v (B,) of a planar
    winner, else 0).

    Lane j of a group takes spheres s = j and planar rows r = j (mod
    group): the first minimum of its sphere roots, then the first minimum
    of its rows that pass `plane_candidate_plain` against that best, then
    t_min <= t < best and the in-plane test. The lanes' winners merge by a
    butterfly of lexicographic (t, family, index) minima, as the kernel's
    shuffles do. The per-primitive forms are the kernel's (the sphere's
    K0 grouping, the affine plane), each product rounded (no FMA)."""
    f32, inf = torch.float32, torch.inf
    B = o.shape[0]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    tm = torch.tensor(t_min, dtype=f32)
    if tab is not None:
        r = {k: tab[i] for i, k in enumerate(TABLE_ROWS)}
        oo = (ox * ox + oy * oy + oz * oz)[:, None]
        od = (ox * dx + oy * dy + oz * dz)[:, None]
        w = (time[:, None] - r["t0"]) * r["inv_dt"]
        cx = r["c0x"] + w * r["dcx"]
        cy = r["c0y"] + w * r["dcy"]
        cz = r["c0z"] + w * r["dcz"]
        hb = od - (dx[:, None] * cx + dy[:, None] * cy + dz[:, None] * cz)
        cc = ((oo - 2.0 * (ox[:, None] * cx + oy[:, None] * cy
                           + oz[:, None] * cz))
              + (r["k0"] + w * (r["k1"] + w * r["k2"])))
        disc = hb * hb - a[:, None] * cc
        sq = torch.sqrt(torch.where(disc > 0, disc, 1.0))
        root = (-hb - sq) * inv_a[:, None]
        root = torch.where(root >= tm, root, (-hb + sq) * inv_a[:, None])
        t_sph = torch.where((disc > 0) & (root >= tm), root, inf)
    if ptab is not None:
        p = {k: ptab[i] for i, k in enumerate(PLANAR_ROWS)}
        num = p["k"] - (p["nx"] * ox[:, None] + p["ny"] * oy[:, None]
                        + p["nz"] * oz[:, None])
        den = p["nx"] * dx[:, None] + p["ny"] * dy[:, None] \
            + p["nz"] * dz[:, None]
    lanes = []
    for j in range(group):
        best = torch.full((B,), inf, dtype=f32)
        fam = torch.full((B,), 2, dtype=torch.int64)
        idx = torch.full((B,), -1, dtype=torch.int64)
        u = torch.zeros((B,), dtype=f32)
        v = torch.zeros((B,), dtype=f32)
        if tab is not None and j < tab.shape[1]:
            m, arg = t_sph[:, j::group].min(dim=1)
            hit = m < inf
            best = m
            fam = torch.where(hit, 0, fam)
            idx = torch.where(hit, j + group * arg, idx)
        if ptab is not None and j < ptab.shape[1]:
            nu, de = num[:, j::group], den[:, j::group]
            cand = plane_candidate_plain(nu, de, t_min, best[:, None])
            t = torch.where(cand, nu / de, inf)
            ok = cand & (t >= tm) & (t < best[:, None])
            hx = ox[:, None] + t * dx[:, None]
            hy = oy[:, None] + t * dy[:, None]
            hz = oz[:, None] + t * dz[:, None]
            sub = {k: p[k][j::group] for k in ("uax", "uay", "uaz", "ca",
                                               "ubx", "uby", "ubz", "cb",
                                               "flag")}
            uu = sub["uax"] * hx + sub["uay"] * hy + sub["uaz"] * hz \
                + sub["ca"]
            vv = sub["ubx"] * hx + sub["uby"] * hy + sub["ubz"] * hz \
                + sub["cb"]
            ok = ok & (uu >= 0) & (vv >= 0) & (vv <= 1) \
                & (uu + sub["flag"] * vv <= 1)
            m, arg = torch.where(ok, t, inf).min(dim=1)
            hit = m < inf   # every passing row is nearer than best
            pick = arg[:, None]
            best = torch.where(hit, m, best)
            fam = torch.where(hit, 1, fam)
            idx = torch.where(hit, j + group * arg, idx)
            u = torch.where(hit, uu.gather(1, pick)[:, 0], u)
            v = torch.where(hit, vv.gather(1, pick)[:, 0], v)
        lanes.append(torch.stack([best, fam.to(f32), idx.to(f32), u, v]))
    cur = torch.stack(lanes)                 # (group, 5, B); idx < 2^24
    off = group >> 1
    while off:
        other = cur[torch.arange(group) ^ off]
        ot, of, oi = other[:, 0], other[:, 1], other[:, 2]
        mt, mf, mi = cur[:, 0], cur[:, 1], cur[:, 2]
        take = (ot < mt) | ((ot == mt) & ((of < mf) | ((of == mf)
                                                        & (oi < mi))))
        cur = torch.where(take[:, None], other, cur)
        off >>= 1
    t, fam, idx, u, v = cur[0]
    return t, fam.long(), idx.long(), u, v


def rand4_device(ray_id: torch.Tensor, depth: int, salt: int,
                 seed: int) -> torch.Tensor:
    """The kernel's device rand4 for int32-bit ray ids on CUDA -> (n, 4) f32.

    A probe for bit-exactness checks against `rng.rand4`; not on the render
    path and not counted in LAUNCHES.
    """
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    if not ray_id.is_cuda or ray_id.dtype != torch.int32:
        raise ValueError("rand4_device takes an int32 CUDA tensor of ray ids")
    ids = ray_id.contiguous()
    out = torch.empty((ids.numel(), 4), dtype=torch.float32, device=ids.device)
    lib = _build.load_library()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.rtw_rand4(ids.data_ptr(), ids.numel(), depth & 0xFFFFFFFF,
                            salt & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                            out.data_ptr(), stream)
    _build.check(lib, err, "rtw_rand4 launch")
    return out
