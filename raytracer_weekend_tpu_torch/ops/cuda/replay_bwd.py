"""Replay backward of the fused render: kernels K2 (spheres), K4 (planar), K7 (deferred).

Counterpart of `raytracer_weekend_tpu/ops/pallas/replay_bwd.py`, sphere and
planar branches and their deferred-texture branch. Given the winner codes
that the fused forward recorded (`megakernel.render_fused(...,
emit_paths=True)`) and the radiance cotangent g, `replay_bwd_fused` returns
the cotangents of the sphere table `pack_ktab(scene)`, of the planar table
`pack_ptab(scene, static)`, of the primary rays (o, d, time) and of the
background. For a scene whose noise and image texels the forward deferred,
g is per bounce, (n, D, 3): the cotangent of the records' contributions
ctb, which the autograd of the deferred combine gives (`fused_diff.py`);
those texels are 1.0 here, and `cabc` (n, D, 3), the cotangent of the noise
records' hit points, joins each such bounce's hit point (K7):

  * for tensors on a CUDA device it launches the hand-written kernels in
    `csrc/replay_bwd.cu` (built at first use by `_build.py`): three small
    ones that order the lanes by their live bounces (`sweep_order` is their
    plain twin), then the replay backward over the lanes in that order; it
    raises if the library does not build or load, or a launch fails.
    d(ktab) is reduced in the block's shared memory when it fits (up to
    3,053 spheres on an H100), else by warp-aggregated global atomics;
    d(ptab) in shared memory beside d(ktab) when both fit, else by the same
    global atomics (a mesh: the cow's 5,805 primitives need 743 KB);
  * for tensors on the CPU it runs `replay_bwd_reference`: torch.autograd
    through `replay.replay_packed` (its deferred form for a per-bounce g)
    on the same codes, which is what the CUDA kernel is held against on the
    card.

The host chains the results through the autograd of `pack_ktab`,
`pack_ptab` and `integrator._pixel_rays` to the scene and camera leaves
(`fused_diff.py`). The TPU kernel's (8, L) planes, one-hot MXU gathers and
transposes, [hi; lo] table split, VMEM stashes and 24-row sphere padding are
not carried over.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raytracer_weekend_tpu_torch import replay
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.cuda.megakernel import _check
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic

# Launches of the CUDA kernel in this process, those whose scene has planar
# primitives (the planar branch) and those with a per-bounce cotangent (the
# deferred branch, K7). Only the launch in `replay_bwd_fused` adds to them.
LAUNCHES = 0
PLANAR_LAUNCHES = 0
DEFER_LAUNCHES = 0

# Rows of the sphere table, in the order of `enum KRow` in
# csrc/replay_bwd.cu: the first KT columns of replay's packed sphere rows
# (`replay._pack_spheres`), whose two last columns (image id, texture id) no
# solid/checker texture reads.
KT_ROWS = ("ax", "ay", "az", "bx", "by", "bz", "r", "r2", "mtype", "fuzz",
           "ior", "ttype", "c1r", "c1g", "c1b", "c2r", "c2g", "c2b", "tscale")
KT = len(KT_ROWS)
# Rows of the planar table, in the order of `enum PRow` in
# csrc/replay_bwd.cu: the JAX `pack_ptab` layout, the geometry and shading
# columns of replay's packed planar rows (`replay._pack_planar`) without the
# uv-debug affines, then the material tail.
KP_ROWS = ("nx", "ny", "nz", "k", "uax", "uay", "uaz", "ca", "ubx", "uby",
           "ubz", "cb", "ns0x", "ns0y", "ns0z", "nsux", "nsuy", "nsuz",
           "nsvx", "nsvy", "nsvz", "mtype", "fuzz", "ior", "ttype", "c1r",
           "c1g", "c1b", "c2r", "c2g", "c2b", "tscale")
KP = len(KP_ROWS)
# Where each row sits among the packed planar row's columns.
_KP_COLS = tuple(replay.PLANAR_COLS.index(r) for r in KP_ROWS)
_STATE = 9   # floats of scratch per lane and bounce: o, d, throughput
# Bins of the kernel's sweep order, csrc/replay_bwd.cu's kBins.
ORDER_BINS = 32


def pack_ktab(scene: SceneData) -> torch.Tensor:
    """(KT, S) differentiable sphere table of the backward kernel.

    The JAX `pack_ktab` (with `_mat_tail_rows`): the coefficients of
    `replay._pack_spheres` (alpha/beta affine center, signed radius,
    radius^2, the material/texture tail resolved per sphere) as rows.
    Autograd of this function routes d(ktab) to the scene leaves.
    """
    return replay._pack_spheres(scene)[:, :KT].T.contiguous()


def pack_ptab(scene: SceneData, static: SceneStatic) -> torch.Tensor:
    """(KP, R + T) differentiable planar table of the backward kernel, rects
    first (the unified planar index).

    The JAX `pack_ptab`: the coefficients of `replay._pack_planar` (plane
    n and k, in-plane affines ua/ca and ub/cb, shading interpolants ns0,
    nsu, nsv) and the material/texture tail, as rows. Autograd of this
    function routes d(ptab) to the scene leaves.
    """
    return replay._pack_planar(scene, static)[:, _KP_COLS].T.contiguous()


def replay_bwd_reference(ktab, ptab, background, cfg: RenderConfig, o, d,
                         time, ray_id, seed, codes, g, cabc=None):
    """Plain torch version: the VJP of the replay with cotangent g.

    ktab and ptab as `replay_bwd_fused` takes them, either None; with a
    per-bounce g (B, D, 3) the VJP of the replay's deferred form with the
    cotangents (g, cabc), cabc (B, D, 3) or None. Returns (dktab (KT,S) or
    None, dptab (KP,R) or None, d_o (B,3), d_d (B,3), d_time (B,), d_bg
    (3,)).
    """
    with torch.enable_grad():
        tabs = [None if t is None else t.detach().requires_grad_()
                for t in (ktab, ptab)]
        ins = [t.detach().requires_grad_() for t in (background, o, d, time)]
        k, p = tabs
        bg, o_, d_, t_ = ins
        sph = pla = None
        if k is not None:   # + the image and texture ids, unread
            sph = torch.cat([k.T, k.new_zeros((k.shape[1], 2))], dim=1)
        if p is not None:   # + the uv-debug affines, and those ids
            pla = p.new_zeros((p.shape[1], len(replay.PLANAR_COLS)))
            pla = pla.index_copy(1, torch.tensor(_KP_COLS, device=p.device),
                                 p.T)
        wrt = [t for t in tabs if t is not None] + ins
        if g.dim() == 3:
            ctb, pn = replay.replay_packed(
                sph, pla, bg, cfg, o_, d_, t_, ray_id, seed, codes,
                replay.Texels(defer=True))
            outs, cots = [ctb], [g]
            if cabc is not None:
                outs.append(pn)
                cots.append(cabc)
        else:
            outs = [replay.replay_packed(sph, pla, bg, cfg, o_, d_, t_,
                                         ray_id, seed, codes)]
            cots = [g]
        grads = iter(torch.autograd.grad(outs, wrt, grad_outputs=cots,
                                         allow_unused=True))
    out = [None if t is None else next(grads) for t in tabs]
    out += [next(grads) for _ in ins]
    dk, dp, dbg, do, dd, dt = (
        None if x is None else (torch.zeros_like(x) if gr is None else gr)
        for gr, x in zip(out, tabs + ins))
    return dk, dp, do, dd, dt, dbg


def sweep_order(codes, n_spheres: int, n_planar: int,
                bins: int = ORDER_BINS):
    """Plain twin of the kernel's sweep order -> (n,) int64: the lanes in
    order of their live bounces, most first, and by index within a count
    (a stable order). A lane's count is its leading codes that name a
    sphere below n_spheres or a planar primitive below n_planar, clamped to
    min(max_depth, bins - 1). The kernel's thread t sweeps lane order[t]
    and writes its outputs at the lane's own index."""
    fam, idx = codes & 3, codes >> 2
    hit = (codes > 0) & (((fam == 1) & (idx < n_spheres))
                         | ((fam == 2) & (idx < n_planar)))
    hits = torch.cumprod(hit.to(torch.int64), dim=1).sum(1)
    hits = hits.clamp_max(min(codes.shape[1], bins - 1))
    return torch.sort(-hits, stable=True).indices


@functools.lru_cache(maxsize=None)
def _smem_limit(lib, device_index: int) -> int:
    """The opt-in shared memory of one block on the card, queried once."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    limit = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.rtw_replay_bwd_smem_limit(ctypes.byref(limit))
    _build.check(lib, err, "cudaDeviceGetAttribute")
    return limit.value


def shared_reductions(lib, device, S: int, R: int) -> tuple[bool, bool]:
    """(d(ktab) in shared memory, d(ptab) in shared memory) for S spheres
    and R planar primitives on `device`: each when it fits one block's
    opt-in shared memory, d(ptab) only beside a shared d(ktab)."""
    limit = _smem_limit(lib, torch.device(device).index or 0)
    sphere = lib.rtw_replay_bwd_smem_bytes(S, 0) <= limit
    return sphere, sphere and lib.rtw_replay_bwd_smem_bytes(S, R) <= limit


def operands(ktab, ptab, background, cfg: RenderConfig, o, d, time, ray_id,
             seed, codes, g, n_chunk: int, cabc=None) -> dict:
    """The kernel's operands for `replay_bwd_fused`'s arguments, checked,
    with its outputs (the table and background cotangents zeroed) and its
    scratch: the argument of `_launch`. Build them once to time the launch
    alone; each launch adds into the cotangents of the tables and the
    background."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    defer = g.dim() == 3
    device = background.device
    n = int(n_chunk)
    lib = _build.load_library()
    S = 0 if ktab is None else ktab.shape[1]
    R = 0 if ptab is None else ptab.shape[1]
    D = cfg.max_depth
    sphere_shared, planar_shared = shared_reductions(lib, device, S, R)
    f32 = torch.float32
    tabs = [None if t is None else t.detach().to(f32).contiguous()
            for t in (ktab, ptab)]
    bg = background.detach().to(f32).contiguous()
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    time = time.detach().contiguous()
    # uint32 ray ids, passed as their int32 bits.
    rid = ray_id.to(torch.int64) & 0xFFFFFFFF
    rid = torch.where(rid >= 2**31, rid - 2**32, rid).to(torch.int32)
    g = g.detach().to(f32).contiguous()
    g_shape = (n, D, 3) if defer else (n, 3)
    if cabc is not None:
        cabc = cabc.detach().to(f32).contiguous()
        _check(cabc, f32, (n, D, 3), device)
    for t, rows, cols in ((tabs[0], KT, S), (tabs[1], KP, R)):
        if t is not None:
            _check(t, f32, (rows, cols), device)
    _check(bg, f32, (3,), device)
    for t, shape in ((o, (n, 3)), (d, (n, 3)), (g, g_shape), (time, (n,))):
        _check(t, f32, shape, device)
    _check(rid, torch.int32, (n,), device)
    _check(codes, torch.int32, (n, D), device)
    return dict(
        tabs=tabs, S=S, R=R, sphere_shared=sphere_shared,
        planar_shared=planar_shared, bg=bg, o=o, d=d, time=time, rid=rid,
        codes=codes, g=g, cabc=cabc, defer=defer, n=n, D=D,
        t_min=float(cfg.t_min), seed=int(seed) & 0xFFFFFFFF,
        order=torch.empty((lib.rtw_replay_bwd_order_ints(n, D),),
                          dtype=torch.int32, device=device),
        scratch=torch.empty((D, _STATE, n), dtype=f32, device=device),
        dtabs=[None if t is None else torch.zeros_like(t) for t in tabs],
        d_bg=torch.zeros((3,), dtype=f32, device=device),
        d_o=torch.empty((n, 3), dtype=f32, device=device),
        d_d=torch.empty((n, 3), dtype=f32, device=device),
        d_time=torch.empty((n,), dtype=f32, device=device))


def _launch(ops: dict):
    """One launch of the kernel on `operands` -> (dktab or None, dptab or
    None, d_o, d_d, d_time, d_bg) of ops."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    device = ops["bg"].device

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_replay_bwd(
            ptr(ops["tabs"][0]), ops["S"], ptr(ops["tabs"][1]), ops["R"],
            int(ops["sphere_shared"]), int(ops["planar_shared"]),
            ops["bg"].data_ptr(), ops["o"].data_ptr(), ops["d"].data_ptr(),
            ops["time"].data_ptr(), ops["rid"].data_ptr(),
            ops["codes"].data_ptr(), ops["g"].data_ptr(), ptr(ops["cabc"]),
            int(ops["defer"]), ops["n"], ops["D"], ops["t_min"], ops["seed"],
            ops["order"].data_ptr(), ops["scratch"].data_ptr(), ptr(ops["dtabs"][0]),
            ptr(ops["dtabs"][1]), ops["d_o"].data_ptr(), ops["d_d"].data_ptr(),
            ops["d_time"].data_ptr(), ops["d_bg"].data_ptr(), stream)
    _build.check(lib, err, "rtw_replay_bwd launch")
    return (*ops["dtabs"], ops["d_o"], ops["d_d"], ops["d_time"],
            ops["d_bg"])


def replay_bwd_fused(ktab, ptab, background, cfg: RenderConfig, o, d, time,
                     ray_id, seed, codes, g, n_chunk: int, cabc=None):
    """Run the replay backward over n_chunk lanes.

    ktab (KT, S) f32 from `pack_ktab` and ptab (KP, R) from `pack_ptab`,
    each None when the scene has no such primitive; background (3,); o, d
    (n, 3) and time (n,) the primary rays; ray_id (n,) the lanes' RNG ids;
    codes (n, max_depth) int32 winner codes; g the radiance cotangent, (n,
    3), or (n, max_depth, 3) per bounce for a scene whose noise and image
    texels were deferred (K7: those texels are 1.0), with cabc (n,
    max_depth, 3) or None the cotangent of the noise records' hit points.
    Returns (dktab (KT,S) or None, dptab (KP,R) or None, d_o (n,3), d_d
    (n,3), d_time (n,), d_bg (3,)). The CPU runs the plain version; CUDA
    runs the kernel.
    """
    global LAUNCHES, PLANAR_LAUNCHES, DEFER_LAUNCHES
    if ktab is None and ptab is None:
        raise ValueError("replay_bwd_fused needs a sphere or a planar table")
    defer = g.dim() == 3
    if cabc is not None and not defer:
        raise ValueError("cabc needs a per-bounce cotangent g (n, D, 3)")
    device = background.device
    if device.type == "cpu":
        return replay_bwd_reference(ktab, ptab, background, cfg, o, d, time,
                                    ray_id, seed, codes, g, cabc)
    if device.type != "cuda":
        raise NotImplementedError(f"no replay backward on {device}")
    out = _launch(operands(ktab, ptab, background, cfg, o, d, time, ray_id,
                           seed, codes, g, n_chunk, cabc))
    LAUNCHES += 1
    if ptab is not None:
        PLANAR_LAUNCHES += 1
    if defer:
        DEFER_LAUNCHES += 1
    return out
