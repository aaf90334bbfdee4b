"""Differentiable fused rendering: fused forward, replay backward.

Port of `raytracer_weekend_tpu/fused_diff.py`, for the scenes that
`megakernel.fused_supported` admits: spheres, rects, triangles and
constant-density media with solid, checker, noise, image or (planar)
uv-debug textures. The fused
forward has no autodiff rule of its own, so `render_fused_diff` is a
`torch.autograd.Function` that pairs

  forward   the fused render emitting per-bounce winner codes: the CUDA
            kernel K1-emit/K3/K5 on a card, its plain version on the CPU
            (`ops.cuda.megakernel.render_fused(..., emit_paths=True)`);
            for a scene with noise or image textures also the deferred
            records (K6a, `emit_deferred=True`), combined into the radiance
            (K8 for the turbulence);
  backward  the replay backward on those saved codes. As in the JAX
            package this is a static choice on `SceneStatic`:
            * neither uv-debug textures nor media: kernels K2/K4 on a
              card, torch.autograd
              through `replay.replay_packed` on the CPU
              (`ops.cuda.replay_bwd.replay_bwd_fused`), chained to the
              scene and camera leaves through the autograd of `pack_ktab`,
              `pack_ptab` and `integrator._pixel_rays`. With deferred
              texels, the combine's VJP first gives the texture table's
              gradients, the per-bounce cotangents g_k of the records'
              contributions and the cotangents cabc of the noise records'
              hit points (image texels only: the VJP kernel of
              `ops.cuda.image_combine`; else torch autograd of the
              combine, the turbulence's through K9), and K2/K4 with their
              deferred branch K7 take those;
            * uv-debug (simple_triangle) or media (smokey_cornell_box,
              book2): torch.autograd through `replay.replay_rays` on every
              device, the port of the JAX package's XLA replay for the
              scenes its kernel does not cover (JAX `fused_diff.py:198-207`).
              The forward of a medium scene still combines its deferred
              texels (K6a, K8) into the radiance; the replay evaluates them
              inline, the turbulence through its plain autograd.

Discrete choices (winners, hit/miss, reflect/refract) are held fixed and
continuous factors differentiate: the staged path's gradient semantics.
The JAX package's peeled-primary prepass (`prepare_peel`) is a TPU table
layout and is not ported.
Without `remat` or `lax.map` pieces (TPU compile-time workarounds), the
deferred combine's autograd (scenes with noise) keeps its texel
intermediates for the whole frame.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch import integrator, replay
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.cuda import megakernel, replay_bwd
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic
from raytracer_weekend_tpu_torch.utils import metrics


class _FusedDiff(torch.autograd.Function):
    """Per-lane radiance as a function of every scene and camera leaf.

    Inputs are the scene's leaves followed by the camera's; integer and bool
    leaves (ids, type tables, valid masks) get no gradient.
    """

    @staticmethod
    def forward(ctx, spec, *leaves):
        static, cfg, lane_start, n_chunk, seed, n_scene, trees = spec
        with metrics.span("rtw.diff.forward"):
            metrics.count("diff_lanes", n_chunk)
            scene = SceneData.from_leaves(leaves[:n_scene], trees)
            cam = Camera(*leaves[n_scene:])
            defer = _defers(static)
            rad, _, codes, *recs = megakernel.render_fused(
                scene, cfg, cam, lane_start, n_chunk, seed, static=static,
                emit_paths=True, emit_deferred=defer)
        ctx.spec = spec
        ctx.n_recs = len(recs)
        ctx.save_for_backward(*recs, codes, *leaves)
        return rad

    @staticmethod
    def backward(ctx, g):
        with metrics.span("rtw.diff.backward"):
            return _FusedDiff._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        static, cfg, lane_start, n_chunk, seed, n_scene, trees = ctx.spec
        saved = ctx.saved_tensors
        recs, codes, leaves = (saved[:ctx.n_recs], saved[ctx.n_recs],
                               list(saved[ctx.n_recs + 1:]))
        wanted = [i for i, t in enumerate(leaves)
                  if t.is_floating_point() and ctx.needs_input_grad[1 + i]]
        g = g.to(torch.float32)
        grads_c = [None] * len(wanted)
        cabc = None
        with torch.enable_grad():
            for i in wanted:
                leaves[i] = leaves[i].detach().requires_grad_()
            scene = SceneData.from_leaves(leaves[:n_scene], trees)
            cam = Camera(*leaves[n_scene:])
            ids = lane_start + torch.arange(n_chunk, dtype=torch.int64,
                                            device=scene.device)
            o, d, time, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
            if _replays(static):
                rad = replay.replay_rays(scene, static, cfg, o, d, time,
                                         ray_id, seed, codes)
            else:
                if recs:
                    g, cabc, grads_c = combine_vjp(
                        scene, static, recs, g, [leaves[i] for i in wanted])
                ktab = (replay_bwd.pack_ktab(scene) if static.n_spheres
                        else None)
                ptab = (replay_bwd.pack_ptab(scene, static)
                        if static.n_rects or static.n_triangles else None)
        if _replays(static):
            pairs = [(rad, g)]
        else:
            dktab, dptab, d_o, d_d, d_time, d_bg = replay_bwd.replay_bwd_fused(
                ktab, ptab, scene.background, cfg, o, d, time, ray_id, seed,
                codes, g, n_chunk, cabc=cabc)
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
        for i, gr, gc in zip(wanted, grads, grads_c):
            parts = [x for x in (gr, gc) if x is not None]
            out[i] = (sum(parts[1:], parts[0]) if parts
                      else torch.zeros_like(leaves[i]))
        return (None, *out)


def _replays(static: SceneStatic) -> bool:
    """The backward is torch autograd of `replay.replay_rays`: the scenes
    kernels K2/K4/K7 do not cover (uv-debug textures, media)."""
    return static.has_uvdebug or static.n_volumes > 0


def _defers(static: SceneStatic) -> bool:
    """The forward returns the deferred records and the backward takes the
    kernels' deferred branch (not for the scenes that replay)."""
    return megakernel.defers(static) and not _replays(static)


def combine_vjp(scene, static, recs, g, wanted_leaves):
    """The deferred combine's VJP with the radiance cotangent g (n, 3) ->
    (g_k (n, D, 3), the records' contribution cotangents; cabc (n, D, 3)
    or None for a scene without noise, the noise hit points' cotangents;
    the gradients of `wanted_leaves`, each None where unused).

    A scene without noise and not single-hit (image texels, the general
    combine) takes `image_combine.combine_images_vjp`: the VJP kernel on a
    card, which adds only live records into the texel atlas's gradient and
    leaves every other leaf None; the forward's combine is not run again.
    Otherwise torch autograd of the combine: dead records (dcode 0) are
    differentiated at abc = 0.5 (whatever abc held there, the masked-zero
    cotangent times a NaN Jacobian of the spherical UV, atan2/asin at 0 or
    at the poles, would poison every geometry gradient), and the
    turbulence runs through `turbulence_diff` (K8 forward, K9 backward;
    their plain versions on the CPU).
    """
    with metrics.span("rtw.diff.combine"):
        return _combine_vjp(scene, static, recs, g, wanted_leaves)


def _combine_vjp(scene, static, recs, g, wanted_leaves):
    from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb

    ctb, abc, dcode = recs
    if not static.has_noise and not static.defer_single_hit:
        from raytracer_weekend_tpu_torch.ops.cuda import image_combine

        images = scene.textures.images
        texel_grad = any(t is images for t in wanted_leaves)
        g_k, d_images = image_combine.combine_images_vjp(
            scene.textures, ctb, abc, dcode, g, texel_grad=texel_grad)
        return g_k, None, [d_images if t is images else None
                           for t in wanted_leaves]
    ctb = ctb.detach().requires_grad_()
    abc = torch.where((dcode != 0)[..., None], abc, 0.5).requires_grad_()

    def noise_fn(grad, perm, p, live):
        return perlin_turb.turbulence_diff(grad, perm, p, 7, live)

    rad = megakernel.combine(scene, static, ctb, abc, dcode,
                             noise_fn=noise_fn)
    wrt = [ctb, abc] + wanted_leaves
    grads = torch.autograd.grad(rad, wrt, grad_outputs=g, allow_unused=True)
    g_k, cabc = grads[0], grads[1]
    if g_k is None:
        g_k = torch.zeros_like(ctb)
    if not static.has_noise or cabc is None:
        cabc = None     # image texels (nearest fetch): d(abc) is 0
    return g_k, cabc, list(grads[2:])


def render_fused_diff(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                      cam: Camera, lane_start: int, n_chunk: int,
                      seed) -> torch.Tensor:
    """Per-lane radiance (n_chunk, 3) with gradients w.r.t. every float leaf
    of `scene` and `cam` (lanes [lane_start, lane_start + n_chunk)).

    On a CUDA device the forward is the fused kernel with codes (K1-emit,
    with the planar branch K3 when the scene has rects or triangles, the
    volume branch K5 when it has media, and the deferred records K6a with
    K8 when it has noise or image textures) and the backward kernel K2/K4
    (K7, after K9, for deferred texels), or torch autograd of the replay
    for uv-debug and medium scenes; a build, load or launch failure raises
    and nothing falls back. On the CPU both are their plain torch versions.
    Scenes outside `megakernel.fused_supported` raise `NotImplementedError`.
    """
    if not megakernel.fused_supported(static, cfg):
        raise NotImplementedError(
            "render_fused_diff covers sphere, rect, triangle and constant-"
            "medium scenes with Lambertian/Metal/Dielectric/DiffuseLight "
            f"materials: {static}")
    spec = (static, cfg, int(lane_start), int(n_chunk), int(seed),
            len(scene.leaves()), scene.trees)
    return _FusedDiff.apply(spec, *scene.leaves(), *cam)
