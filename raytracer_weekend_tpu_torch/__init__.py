"""raytracer_weekend_tpu_torch — the PyTorch/CUDA port of raytracer_weekend_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and never jax. It covers sphere and planar scenes (rects, cuboids,
triangles, OBJ meshes; solid, checker and uv-debug textures): the forward
render, and the differentiable render with inverse rendering:

  models.scenes            — jumpy_balls, two_spheres, cornell_box,
                             simple_triangle, the cow and suspension meshes
  scene.builder / data     — sphere + planar DSL compiled to SoA tensor tables
  scene.objloader          — Wavefront OBJ/MTL -> builder triangles
  scene.convert            — JAX scene <-> port, through numpy arrays
  integrator               — staged wavefront renderer (plain torch) and the
                             render_image dispatch
  ops.sphere / rect / triangle — staged closest hit and hit record per family
  ops.bvh / native         — skip-link BVH (plain traverse), the C++ builder
  ops.cuda.bvh_traverse    — the hand-written CUDA tree walk of the staged
                             path (an autograd.Function)
  scene.io / utils.cli / utils.checkpoint / utils.metrics / utils.debug /
  parallel.stream / utils.live_view — the single-device front end
  ops.cuda.megakernel      — the hand-written CUDA forward kernel (sm_90a;
                             sphere and planar branches), optionally writing
                             winner codes, and its plain torch twin
  ops.cuda.replay_bwd      — the hand-written CUDA replay-backward kernel and
                             its plain twin (torch autograd of `replay`)
  replay                   — path replay from winner codes (differentiable)
  fused_diff               — render_fused_diff, a torch.autograd.Function
  train                    — InverseRenderer: Adam over the float leaves
  materials / textures     — solid/checker/uv-debug; Lambertian/Metal/
                             Dielectric/DiffuseLight
  camera / vecmath / rng   — thin-lens camera, vector math, bit-exact PCG4D
"""

__version__ = "0.1.0"

from raytracer_weekend_tpu_torch.camera import Camera, make_camera
from raytracer_weekend_tpu_torch.config import RenderConfig

__all__ = ["Camera", "make_camera", "RenderConfig"]
