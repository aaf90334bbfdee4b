"""raytracer_weekend_tpu_torch — the PyTorch/CUDA port of raytracer_weekend_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and never jax. It covers sphere scenes: the forward render, and the
differentiable render with inverse rendering:

  models.scenes            — jumpy_balls, two_spheres
  scene.builder / data     — sphere-subset DSL compiled to SoA tensor tables
  scene.convert            — JAX scene <-> port, through numpy arrays
  integrator               — staged wavefront renderer (plain torch) and the
                             render_image dispatch
  ops.sphere               — staged closest-sphere hit and hit record
  ops.cuda.megakernel      — the hand-written CUDA forward kernel (sm_90a),
                             optionally writing winner codes, and its plain
                             torch twin
  ops.cuda.replay_bwd      — the hand-written CUDA replay-backward kernel and
                             its plain twin (torch autograd of `replay`)
  replay                   — path replay from winner codes (differentiable)
  fused_diff               — render_fused_diff, a torch.autograd.Function
  train                    — InverseRenderer: Adam over the float leaves
  materials / textures     — solid/checker Lambertian/Metal/Dielectric/Light
  camera / vecmath / rng   — thin-lens camera, vector math, bit-exact PCG4D
"""

__version__ = "0.1.0"

from raytracer_weekend_tpu_torch.camera import Camera, make_camera
from raytracer_weekend_tpu_torch.config import RenderConfig

__all__ = ["Camera", "make_camera", "RenderConfig"]
