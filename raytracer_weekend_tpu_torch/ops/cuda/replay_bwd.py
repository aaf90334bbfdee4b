"""Replay backward of the fused render, sphere family: kernel K2 and its twin.

Counterpart of `raytracer_weekend_tpu/ops/pallas/replay_bwd.py`, sphere
branch. Given the winner codes that the fused forward recorded
(`megakernel.render_fused(..., emit_paths=True)`) and the radiance
cotangent g, `replay_bwd_fused` returns the cotangents of the sphere table
`pack_ktab(scene)`, of the primary rays (o, d, time) and of the background:

  * for tensors on a CUDA device it launches the hand-written kernel in
    `csrc/replay_bwd.cu` (built at first use by `_build.py`) and raises if
    the library does not build or load, the table does not fit the block's
    shared memory, or the launch fails;
  * for tensors on the CPU it runs `replay_bwd_reference`: torch.autograd
    through `replay.replay_packed` on the same codes, which is what the
    CUDA kernel is held against on the card.

The host chains the results through the autograd of `pack_ktab` and of
`integrator._pixel_rays` to the scene and camera leaves (`fused_diff.py`).
The TPU kernel's (8, L) planes, one-hot MXU gathers and transposes, [hi; lo]
table split, VMEM stashes and 24-row padding are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_weekend_tpu_torch import replay
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.cuda.megakernel import _check
from raytracer_weekend_tpu_torch.scene.data import SceneData

# Launches of the CUDA kernel in this process. Only the launch in
# `replay_bwd_fused` adds to it.
LAUNCHES = 0

# Rows of the sphere table, in the order of `enum KRow` in
# csrc/replay_bwd.cu: the first KT columns of replay's packed sphere rows
# (`replay._pack_spheres`), whose two last columns (image id, texture id) no
# solid/checker texture reads.
KT_ROWS = ("ax", "ay", "az", "bx", "by", "bz", "r", "r2", "mtype", "fuzz",
           "ior", "ttype", "c1r", "c1g", "c1b", "c2r", "c2g", "c2b", "tscale")
KT = len(KT_ROWS)
_STATE = 9   # floats of scratch per lane and bounce: o, d, throughput


def pack_ktab(scene: SceneData) -> torch.Tensor:
    """(KT, S) differentiable sphere table of the backward kernel.

    The JAX `pack_ktab` (with `_mat_tail_rows`): the coefficients of
    `replay._pack_spheres` (alpha/beta affine center, signed radius,
    radius^2, the material/texture tail resolved per sphere) as rows.
    Autograd of this function routes d(ktab) to the scene leaves.
    """
    return replay._pack_spheres(scene)[:, :KT].T.contiguous()


def replay_bwd_reference(ktab, background, cfg: RenderConfig, o, d, time,
                         ray_id, seed, codes, g):
    """Plain torch version: the VJP of the replay with cotangent g.

    Returns (dktab (KT,S), d_o (B,3), d_d (B,3), d_time (B,), d_bg (3,)).
    """
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in
               (ktab, background, o, d, time)]
        k, bg, o_, d_, t_ = ins
        pad = torch.zeros((k.shape[1], 2), dtype=k.dtype, device=k.device)
        sph_tab = torch.cat([k.T, pad], dim=1)
        rad = replay.replay_packed(sph_tab, bg, cfg, o_, d_, t_, ray_id, seed,
                                   codes)
        grads = torch.autograd.grad(rad, ins, grad_outputs=g,
                                    allow_unused=True)
    dk, dbg, do, dd, dt = (torch.zeros_like(x) if gr is None else gr
                           for gr, x in zip(grads, ins))
    return dk, do, dd, dt, dbg


def replay_bwd_fused(ktab, background, cfg: RenderConfig, o, d, time, ray_id,
                     seed, codes, g, n_chunk: int):
    """Run the replay backward over n_chunk lanes.

    ktab (KT, S) f32 from `pack_ktab`; background (3,); o, d (n, 3) and
    time (n,) the primary rays; ray_id (n,) the lanes' RNG ids; codes
    (n, max_depth) int32 winner codes; g (n, 3) the radiance cotangent.
    Returns (dktab (KT,S), d_o (n,3), d_d (n,3), d_time (n,), d_bg (3,)).
    The CPU runs the plain version; CUDA runs the kernel.
    """
    global LAUNCHES
    device = ktab.device
    n = int(n_chunk)
    if device.type == "cpu":
        return replay_bwd_reference(ktab, background, cfg, o, d, time,
                                    ray_id, seed, codes, g)
    if device.type != "cuda":
        raise NotImplementedError(f"no replay backward on {device}")

    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    S = ktab.shape[1]
    D = cfg.max_depth
    smem = lib.rtw_replay_bwd_smem_bytes(S)
    limit = ctypes.c_int(0)   # the opt-in shared memory of one block
    with torch.cuda.device(device):
        err = lib.rtw_replay_bwd_smem_limit(ctypes.byref(limit))
    _build.check(lib, err, "cudaDeviceGetAttribute")
    if smem > limit.value:
        raise ValueError(
            f"the replay backward keeps d(ktab) ({KT} x {S} f32, {smem} bytes)"
            f" in one block's shared memory; this device allows "
            f"{limit.value} bytes, so at most "
            f"{(limit.value - 12) // (4 * KT)} spheres")
    f32 = torch.float32
    ktab = ktab.detach().to(f32).contiguous()
    bg = background.detach().to(f32).contiguous()
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    time = time.detach().contiguous()
    # uint32 ray ids, passed as their int32 bits.
    rid = ray_id.to(torch.int64) & 0xFFFFFFFF
    rid = torch.where(rid >= 2**31, rid - 2**32, rid).to(torch.int32)
    g = g.detach().to(f32).contiguous()
    _check(ktab, f32, (KT, S), device)
    _check(bg, f32, (3,), device)
    for t, shape in ((o, (n, 3)), (d, (n, 3)), (g, (n, 3)), (time, (n,))):
        _check(t, f32, shape, device)
    _check(rid, torch.int32, (n,), device)
    _check(codes, torch.int32, (n, D), device)

    dktab = torch.zeros((KT, S), dtype=f32, device=device)
    d_bg = torch.zeros((3,), dtype=f32, device=device)
    d_o = torch.empty((n, 3), dtype=f32, device=device)
    d_d = torch.empty((n, 3), dtype=f32, device=device)
    d_time = torch.empty((n,), dtype=f32, device=device)
    scratch = torch.empty((D, _STATE, n), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_replay_bwd(
            ktab.data_ptr(), S, bg.data_ptr(), o.data_ptr(), d.data_ptr(),
            time.data_ptr(), rid.data_ptr(), codes.data_ptr(), g.data_ptr(),
            n, D, float(cfg.t_min), int(seed) & 0xFFFFFFFF,
            scratch.data_ptr(), dktab.data_ptr(), d_o.data_ptr(),
            d_d.data_ptr(), d_time.data_ptr(), d_bg.data_ptr(), stream)
    _build.check(lib, err, "rtw_replay_bwd launch")
    LAUNCHES += 1
    return dktab, d_o, d_d, d_time, d_bg
