"""Inverse rendering: fit scene parameters to a target image (port of `train.py`).

Adam over every float leaf of the scene (texture colors, image texels,
noise scale and Perlin gradients, metal fuzz, dielectric IOR, sphere, rect
and triangle geometry, the media's boundaries and densities, the
background);
integer and bool leaves (type tables, ids, valid masks) stay frozen, the
counterpart of the JAX package's `optax.multi_transform` with `set_to_zero`.

    from raytracer_weekend_tpu_torch.train import InverseRenderer
    ir = InverseRenderer(static, cfg, cam, target_image)
    scene, history = ir.fit(scene, steps=100)

or step by step, with Adam's state in reach:

    run = ir.start(scene)
    for i in range(100):
        loss = run.step()        # or run.step(seed=...): other samples
    scene = run.scene

With `rmesh` (a `parallel.mesh.RenderMesh`) every rank of the mesh runs
the fit with the same scene: the render goes through
`parallel.shard.render_sharded` (on a card a rays-only mesh with a scene
that `integrator.fused_eligible` admits takes `render_fused_diff` per
shard), every rank counts the loss with the weight 1 / (ranks in the mesh),
the float leaves' gradients are summed over the world
(`shard.reduce_gradients`) and every rank takes the same Adam step.

Without it the render follows the scene's device: on a CUDA device a scene that
`integrator.fused_eligible` admits renders through
`fused_diff.render_fused_diff` (the forward kernel with winner codes, the
replay-backward kernel, or for uv-debug and medium scenes torch autograd
of the replay), and any other scene through the staged path under autograd
(`integrator.render_chunk`, the JAX package's training route: the
closest-hit kernels K10-K12, whose backward re-derives each winner's t); on
the CPU the staged torch path under autograd. Either renders in
`cfg.ray_batch` lane chunks (the whole frame by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic
from raytracer_weekend_tpu_torch.utils import metrics


@dataclasses.dataclass
class InverseRenderer:
    """L2 inverse rendering with Adam over the differentiable scene leaves."""

    static: SceneStatic
    cfg: RenderConfig
    cam: Camera
    target: torch.Tensor                 # (H, W, 3) mean radiance
    rmesh: object = None                 # parallel.mesh.RenderMesh or None
    learning_rate: float = 1e-2
    loss_fn: Optional[Callable] = None   # (img, target) -> scalar; default L2

    def _render(self, scene: SceneData) -> torch.Tensor:
        cfg, device = self.cfg, scene.device
        if self.rmesh is not None:
            from raytracer_weekend_tpu_torch.parallel.shard import (
                render_sharded)
            sums = render_sharded(scene, self.static, cfg, self.cam,
                                  self.rmesh, diff=True)
            return sums / cfg.samples_per_pixel
        n = cfg.n_rays
        batch = cfg.ray_batch or n
        if integrator.fused_eligible(self.static, cfg, device):
            from raytracer_weekend_tpu_torch.fused_diff import (
                render_fused_diff)

            def chunk(start, size):
                return render_fused_diff(scene, self.static, cfg, self.cam,
                                         start, size, cfg.seed)
        else:
            def chunk(start, size):
                ids = start + torch.arange(size, dtype=torch.int64,
                                           device=device)
                return integrator.render_chunk(scene, self.static, cfg,
                                               self.cam, ids, cfg.seed)
        colors = torch.cat([chunk(start, min(batch, n - start))
                            for start in range(0, n, batch)])
        spp = cfg.samples_per_pixel
        sums = colors.reshape(cfg.n_pixels, spp, 3).sum(1).reshape(
            cfg.height, cfg.width, 3)
        return sums / spp

    def loss(self, scene: SceneData) -> torch.Tensor:
        img = self._render(scene)
        if self.loss_fn is not None:
            return self.loss_fn(img, self.target)
        return torch.mean((img - self.target) ** 2)

    def _backward(self, leaves, trees, params) -> float:
        """The loss of the scene `leaves` make, its gradient left in the
        float leaves' `.grad` (summed over the mesh's world with `rmesh`)."""
        loss = self.loss(SceneData.from_leaves(leaves, trees))
        if self.rmesh is None:
            loss.backward()
        else:
            from raytracer_weekend_tpu_torch.parallel.shard import (
                reduce_gradients)
            (loss / self.rmesh.size).backward()
            reduce_gradients(params, self.rmesh)
        return float(loss.detach())

    def value_and_grad(self, scene: SceneData):
        """(loss, the gradient of every float leaf of `scene`, in leaf
        order; zeros where the loss does not reach a leaf)."""
        leaves = [t.detach().clone() for t in scene.leaves()]
        params = [t.requires_grad_() for t in leaves if t.is_floating_point()]
        loss = self._backward(leaves, scene.trees, params)
        return loss, [p.grad if p.grad is not None else torch.zeros_like(p)
                      for p in params]

    def start(self, scene: SceneData) -> "FitRun":
        """A fit from `scene`, stepped by the caller (`FitRun.step`). The
        scene passed in is not modified."""
        leaves = [t.detach().clone() for t in scene.leaves()]
        params = [t.requires_grad_() for t in leaves if t.is_floating_point()]
        opt = torch.optim.Adam(params, lr=self.learning_rate)
        return FitRun(self, leaves, scene.trees, params, opt)

    def fit(self, scene: SceneData, steps: int = 100,
            callback: Optional[Callable] = None):
        """Run `steps` of Adam. Returns (optimized_scene, loss_history).

        `callback(i, loss, scene)` runs after each step with the updated
        scene. The scene passed in is not modified.
        """
        run = self.start(scene)
        history = []
        for i in range(steps):
            history.append(run.step())
            if callback is not None:
                callback(i, history[-1], run.scene)
        return run.scene, history


@dataclasses.dataclass
class FitRun:
    """One fit in progress: the float leaves being fitted (`params`, in
    leaf order) and their Adam (`optimizer`, whose `state[p]` holds each
    leaf's `exp_avg` and `exp_avg_sq`)."""

    renderer: InverseRenderer
    leaves: list
    trees: tuple
    params: list
    optimizer: torch.optim.Adam

    def step(self, seed: Optional[int] = None) -> float:
        """One Adam step -> the loss before it. `seed` draws the step's
        samples (the renderer's `cfg.seed` by default)."""
        ir = self.renderer
        with metrics.span("rtw.fit.step"):
            if seed is not None and seed != ir.cfg.seed:
                ir = dataclasses.replace(
                    ir, cfg=dataclasses.replace(ir.cfg, seed=int(seed)))
            self.optimizer.zero_grad(set_to_none=True)
            loss = ir._backward(self.leaves, self.trees, self.params)
            with metrics.span("rtw.fit.adam"):
                self.optimizer.step()
        return loss

    @property
    def scene(self) -> SceneData:
        """The scene at the current parameters, detached."""
        return _detached(self.leaves, self.trees)


def _detached(leaves, trees) -> SceneData:
    return SceneData.from_leaves([t.detach() for t in leaves], trees)
