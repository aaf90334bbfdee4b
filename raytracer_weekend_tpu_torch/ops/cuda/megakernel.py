"""Fused forward render: the CUDA megakernel and its plain twin.

Counterpart of `raytracer_weekend_tpu/ops/pallas/megakernel.py`, sphere
branch (K1), planar branch (K3: axis-aligned rects and triangles in one
table) and deferred-texture record arm (K6a). `render_fused` renders a
window of lanes (lane = pixel*spp + sample) and returns per-lane radiance
and traced segment counts:

  * for a scene on a CUDA device it launches the hand-written kernel in
    `csrc/megakernel.cu` (built at first use by `_build.py`) and raises if
    the library does not build or load, or the launch fails;
  * for a scene on the CPU it runs `render_fused_reference`, the plain torch
    version (`integrator._pixel_rays` + `integrator.trace_lanes`), which is
    what the CUDA kernel is held against on the card.

With `emit_paths=True` it also returns the per-bounce winner codes (n, D)
int32 where the lane was alive and hit: 1 + 4*idx for sphere idx, 2 + 4*idx
for planar primitive idx (rects first, then triangles); else 0. That is the
JAX kernel's `emit_paths` output (there f32), which the backward replays
(`fused_diff.py`).

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

None of the JAX kernel's TPU layout is carried over (K-split bf16 tables,
one-hot MXU gathers, sublane planes, chunk lists and their AABB culling,
`p_stream`, peeled primaries, block tiling, deep-phase compaction): a thread
carries a lane and reads table rows by index.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch import integrator, replay
from raytracer_weekend_tpu_torch import textures as tex_mod
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.sphere import sphere_uv
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic
from raytracer_weekend_tpu_torch.textures import TextureTable

# Launches of the CUDA kernel in this process, without and with the winner
# codes, those whose scene has planar primitives (the planar branch, with or
# without codes), and those in deferred-texture mode (K6a, with or without
# codes). Only the launch in `render_fused` adds to them.
LAUNCHES = 0
EMIT_LAUNCHES = 0
PLANAR_LAUNCHES = 0
DEFER_LAUNCHES = 0

# Rows of the sphere table, in the order of `enum Row` in csrc/megakernel.cu.
TABLE_ROWS = (
    "c0x", "c0y", "c0z", "dcx", "dcy", "dcz", "t0", "inv_dt", "dt", "r2",
    "radius", "mtype", "fuzz", "ior", "ttype",
    "c1r", "c1g", "c1b", "c2r", "c2g", "c2b", "tscale", "tid",
)
PAR_SIZE = 24
# Rows of the planar table, in the order of `enum PRow` in csrc/megakernel.cu.
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

    Scenes of spheres and/or rects and triangles that the builder marks
    `fused_simple` (Lambertian/Metal/Dielectric/DiffuseLight materials over
    solid, checker, noise, image or, on planar primitives, uv-debug
    textures), without volumes. The JAX kernel's 2,048-sphere and
    128k-primitive caps came from TPU VMEM and are not carried over.
    """
    return (static.fused_simple
            and static.n_spheres + static.n_rects + static.n_triangles > 0
            and static.n_volumes == 0
            and cfg.width > 1 and cfg.height > 1)


def defers(static: SceneStatic) -> bool:
    """The fused render of this scene defers noise and image texels."""
    return bool(static.has_noise or static.has_image)


def build_sphere_table(scene: SceneData) -> torch.Tensor:
    """(len(TABLE_ROWS), S) float32 SoA table on the scene's device.

    Material and texture fields are gathered per sphere, so the kernel reads
    one column per hit. Padding rows get r2 = -inf and never hit.
    """
    sp, mt, tx = scene.spheres, scene.materials, scene.textures
    mat = sp.mat.long()
    tex = mt.tex[mat].long()
    dt = sp.t1 - sp.t0
    dc = sp.c1 - sp.c0
    r2 = torch.where(sp.valid, sp.radius * sp.radius, -torch.inf)
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
    }
    return torch.stack([cols[r].to(torch.float32) for r in TABLE_ROWS])


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
    `integrator.trace_lanes`)."""
    ids = lane_start + torch.arange(n_chunk, dtype=torch.int64,
                                    device=scene.device)
    o, d, time, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
    return integrator.trace_lanes(scene, static, cfg, o, d, time, ray_id,
                                  seed, emit_paths=emit_paths,
                                  emit_deferred=defers(static))


def _finish(scene, static, out, emit_deferred, noise_fn=None):
    """(rad, seg, [codes], [ctb, abc, dcode]) -> the render's outputs: a
    deferring scene's radiance is the combine of its records, which are
    returned only with `emit_deferred`."""
    if not defers(static):
        return out
    rad, seg, *rest = out
    ctb, abc, dcode = rest[-3:]
    rad = combine(scene, static, ctb, abc, dcode, noise_fn)
    return ((rad, seg) + tuple(rest[:-3])
            + ((ctb, abc, dcode) if emit_deferred else ()))


def _turbulence_k8(grad, perm, p, live):
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb

    return perlin_turb.turbulence(grad, perm, p, 7, live)


def _turbulence_plain(grad, perm, p, live):
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb

    return perlin_turb.turbulence_reference(grad, perm, p, 7, live)


def combine(scene: SceneData, static: SceneStatic, ctb, abc, dcode,
            noise_fn=None):
    """The deferred combine the scene takes -> radiance (n, 3):
    `combine_deferred_single` when `static.defer_single_hit`, else
    `combine_deferred`. `noise_fn` as `textures.texture_value`'s, by
    default K8 (forward only; its plain version on the CPU)."""
    if static.defer_single_hit:
        return combine_deferred_single(scene.textures, ctb, abc, dcode)
    return combine_deferred(scene.textures, ctb, abc, dcode,
                            has_noise=static.has_noise,
                            has_image=static.has_image,
                            noise_fn=noise_fn or _turbulence_k8)


def combine_deferred(textures: TextureTable, ctb, abc, dcode, *,
                     has_noise: bool, has_image: bool, noise_fn=None):
    """rad = sum_k ctb_k * prod_{j<=k} f_k over the deferred texels -> (n,3).

    The JAX `_combine_deferred`: the texel f_k of record k is
    `textures.texture_value` at texture |dcode| - 1, with the spherical UV
    of abc for a sphere's image texel (dcode > 0), abc's (u, v) for a planar
    one and abc as the point for noise; f_k = 1 where dcode is 0. The
    product is inclusive at the emitting bounce. Differentiable in the
    texture table, ctb and abc (at records where dcode is 0, abc must be a
    regular point for the spherical UV's Jacobian: the caller's anchor).
    """
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
    f = torch.where(live[..., None], f, 1.0)
    # The running product over the D bounces as D products: on a card,
    # torch's scan along a short innermost dimension runs one row per
    # thread and took longer than the whole forward kernel.
    cp, rad = None, None
    for k in range(f.shape[1]):
        cp = f[:, k] if cp is None else cp * f[:, k]
        term = ctb[:, k] * cp
        rad = term if rad is None else rad + term
    return rad


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
                 emit_deferred: bool = False):
    """Render lanes [lane_start, lane_start + n_chunk).

    Returns (radiance (n_chunk, 3) f32, segments (n_chunk,) int32) on the
    scene's device, with `emit_paths` the winner codes (n_chunk, max_depth)
    int32, and with `emit_deferred` (a scene with noise or image textures)
    the deferred-texture records ctb (n_chunk, max_depth, 3) f32, abc
    (n_chunk, max_depth, 3) f32 and dcode (n_chunk, max_depth) int32. The
    CPU runs the plain version; CUDA runs the kernel, and for a deferring
    scene the combine with K8.
    """
    if emit_deferred and not defers(static):
        raise ValueError("emit_deferred needs a scene with noise or image "
                         "textures")
    out = render_fused_records(scene, cfg, cam, lane_start, n_chunk, seed,
                               static=static, emit_paths=emit_paths)
    return _finish(scene, static, out, emit_deferred)


def render_fused_records(scene: SceneData, cfg: RenderConfig, cam: Camera,
                         lane_start: int, n_chunk: int, seed, *,
                         static: SceneStatic, emit_paths: bool = False):
    """The fused kernel's own outputs, before any combine: (radiance,
    segments), with `emit_paths` the codes, and for a deferring scene the
    records (ctb, abc, dcode), the radiance then lacking the deferred
    texels. CUDA launches the kernel (K1/K3, K6a when deferring); the CPU
    runs `records_reference`."""
    global LAUNCHES, EMIT_LAUNCHES, PLANAR_LAUNCHES, DEFER_LAUNCHES
    device = scene.device
    if device.type == "cpu":
        return records_reference(scene, cfg, cam, lane_start, n_chunk, seed,
                                 static=static, emit_paths=emit_paths)
    if device.type != "cuda":
        raise NotImplementedError(f"no fused render on {device}")
    if not fused_supported(static, cfg):
        raise NotImplementedError(f"the CUDA megakernel does not cover this "
                                  f"scene/config: {static}, {cfg}")
    n_chunk = int(n_chunk)
    lane_start = int(lane_start)
    if n_chunk < 0 or lane_start < 0 or lane_start + n_chunk > cfg.n_rays:
        raise ValueError(f"lane window [{lane_start}, {lane_start + n_chunk}) "
                         f"outside [0, {cfg.n_rays})")
    if n_chunk >= 2**31:
        raise ValueError("n_chunk must fit in int32")

    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    n_spheres = scene.spheres.c0.shape[0] if static.n_spheres else 0
    n_planar = static.n_rects + static.n_triangles
    tab = build_sphere_table(scene) if n_spheres else None
    ptab = build_planar_table(scene, static) if n_planar else None
    par = pack_par(scene, cam)
    if n_spheres:
        _check(tab, torch.float32, (len(TABLE_ROWS), n_spheres), device)
    if n_planar:
        _check(ptab, torch.float32, (len(PLANAR_ROWS), n_planar), device)
    _check(par, torch.float32, (PAR_SIZE,), device)
    rad = torch.empty((n_chunk, 3), dtype=torch.float32, device=device)
    seg = torch.empty((n_chunk,), dtype=torch.int32, device=device)
    D = cfg.max_depth
    codes = (torch.empty((n_chunk, D), dtype=torch.int32, device=device)
             if emit_paths else None)
    recs = [None] * 3
    if defers(static):
        recs = [torch.empty((n_chunk, D, 3), dtype=torch.float32,
                            device=device),
                torch.empty((n_chunk, D, 3), dtype=torch.float32,
                            device=device),
                torch.empty((n_chunk, D), dtype=torch.int32, device=device)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_render_fused(
            tab.data_ptr() if n_spheres else None, n_spheres,
            ptab.data_ptr() if n_planar else None, n_planar,
            par.data_ptr(), lane_start, n_chunk,
            cfg.width, cfg.height, cfg.samples_per_pixel, D,
            float(cfg.t_min), int(seed) & 0xFFFFFFFF, rad.data_ptr(),
            seg.data_ptr(),
            *(None if t is None else t.data_ptr() for t in [codes] + recs),
            stream)
    _build.check(lib, err, "rtw_render_fused launch")
    if n_planar:
        PLANAR_LAUNCHES += 1
    if recs[0] is not None:
        DEFER_LAUNCHES += 1
    if emit_paths:
        EMIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return (rad, seg) + ((codes,) if emit_paths else ()) + (
        tuple(recs) if recs[0] is not None else ())


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
