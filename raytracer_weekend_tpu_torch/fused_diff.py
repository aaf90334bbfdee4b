"""Differentiable fused rendering: fused forward, replay backward.

Port of `raytracer_weekend_tpu/fused_diff.py`, for the scenes that
`megakernel.fused_supported` admits: spheres, rects and triangles with
solid, checker or (planar) uv-debug textures. The fused forward has no
autodiff rule of its own, so `render_fused_diff` is a
`torch.autograd.Function` that pairs

  forward   the fused render emitting per-bounce winner codes: the CUDA
            kernel K1-emit/K3 on a card, its plain version on the CPU
            (`ops.cuda.megakernel.render_fused(..., emit_paths=True)`);
  backward  the replay backward on those saved codes. As in the JAX
            package this is a static choice on `SceneStatic`:
            * no uv-debug texture: kernels K2/K4 on a card, torch.autograd
              through `replay.replay_packed` on the CPU
              (`ops.cuda.replay_bwd.replay_bwd_fused`), chained to the
              scene and camera leaves through the autograd of `pack_ktab`,
              `pack_ptab` and `integrator._pixel_rays`;
            * uv-debug (simple_triangle): torch.autograd through
              `replay.replay_rays` on every device, the port of the JAX
              package's XLA replay for the scenes its kernel does not cover.

Discrete choices (winners, hit/miss, reflect/refract) are held fixed and
continuous factors differentiate: the staged path's gradient semantics.
The JAX package's peeled-primary prepass (`prepare_peel`) is a TPU table
layout and is not ported; volume scenes raise `NotImplementedError`.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch import integrator, replay
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.cuda import megakernel, replay_bwd
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic


class _FusedDiff(torch.autograd.Function):
    """Per-lane radiance as a function of every scene and camera leaf.

    Inputs are the scene's leaves followed by the camera's; integer and bool
    leaves (ids, type tables, valid masks) get no gradient.
    """

    @staticmethod
    def forward(ctx, spec, *leaves):
        static, cfg, lane_start, n_chunk, seed, n_scene = spec
        scene = SceneData.from_leaves(leaves[:n_scene])
        cam = Camera(*leaves[n_scene:])
        rad, _, codes = megakernel.render_fused(
            scene, cfg, cam, lane_start, n_chunk, seed, static=static,
            emit_paths=True)
        ctx.spec = spec
        ctx.save_for_backward(codes, *leaves)
        return rad

    @staticmethod
    def backward(ctx, g):
        static, cfg, lane_start, n_chunk, seed, n_scene = ctx.spec
        codes, *leaves = ctx.saved_tensors
        wanted = [i for i, t in enumerate(leaves)
                  if t.is_floating_point() and ctx.needs_input_grad[1 + i]]
        g = g.to(torch.float32)
        with torch.enable_grad():
            for i in wanted:
                leaves[i] = leaves[i].detach().requires_grad_()
            scene = SceneData.from_leaves(leaves[:n_scene])
            cam = Camera(*leaves[n_scene:])
            ids = lane_start + torch.arange(n_chunk, dtype=torch.int64,
                                            device=scene.device)
            o, d, time, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
            if static.has_uvdebug:
                rad = replay.replay_rays(scene, static, cfg, o, d, time,
                                         ray_id, seed, codes)
            else:
                ktab = (replay_bwd.pack_ktab(scene) if static.n_spheres
                        else None)
                ptab = (replay_bwd.pack_ptab(scene, static)
                        if static.n_rects or static.n_triangles else None)
        if static.has_uvdebug:
            pairs = [(rad, g)]
        else:
            dktab, dptab, d_o, d_d, d_time, d_bg = replay_bwd.replay_bwd_fused(
                ktab, ptab, scene.background, cfg, o, d, time, ray_id, seed,
                codes, g, n_chunk)
            # Chain through the packings and _pixel_rays to the leaves.
            pairs = [(ktab, dktab), (ptab, dptab), (scene.background, d_bg),
                     (o, d_o), (d, d_d), (time, d_time)]
        pairs = [(t, c) for t, c in pairs if t is not None and t.requires_grad]
        grads = [None] * len(wanted)
        if pairs:
            grads = torch.autograd.grad(
                [t for t, _ in pairs], [leaves[i] for i in wanted],
                grad_outputs=[c for _, c in pairs], allow_unused=True)
        out = [None] * len(leaves)
        for i, gr in zip(wanted, grads):
            out[i] = torch.zeros_like(leaves[i]) if gr is None else gr
        return (None, *out)


def render_fused_diff(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                      cam: Camera, lane_start: int, n_chunk: int,
                      seed) -> torch.Tensor:
    """Per-lane radiance (n_chunk, 3) with gradients w.r.t. every float leaf
    of `scene` and `cam` (lanes [lane_start, lane_start + n_chunk)).

    On a CUDA device the forward is the fused kernel with codes (K1-emit,
    with the planar branch K3 when the scene has rects or triangles) and the
    backward kernel K2/K4, or torch autograd of the replay for uv-debug
    scenes; a build, load or launch failure raises and nothing falls back.
    On the CPU both are their plain torch versions. Scenes outside
    `megakernel.fused_supported` raise `NotImplementedError`.
    """
    if not megakernel.fused_supported(static, cfg):
        raise NotImplementedError(
            "render_fused_diff covers sphere, rect and triangle scenes with "
            "solid/checker/uv-debug Lambertian/Metal/Dielectric/DiffuseLight "
            f"materials: {static}")
    spec = (static, cfg, int(lane_start), int(n_chunk), int(seed),
            len(scene.leaves()))
    return _FusedDiff.apply(spec, *scene.leaves(), *cam)
