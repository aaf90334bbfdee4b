"""Render configuration, field for field the JAX package's `RenderConfig`.

The JAX package's `config.py` imports no jax itself, but importing it runs
`raytracer_weekend_tpu/__init__.py`, which does; so the port keeps its own
copy. `tests/test_torch_scene.py` holds the two field for field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render.

    Attributes:
      width: image width in pixels (ref default 400).
      height: image height in pixels (ref: round(width / aspect_ratio)).
      samples_per_pixel: Monte Carlo samples per pixel (ref default 100).
      max_depth: bounce-depth bound; the reference recurses up to 50.
      seed: base seed of the counter-based RNG.
      ray_batch: number of lanes traced per chunk; 0 means one chunk.
      t_min: minimum hit distance, ref uses 0.001.
      use_log10_volume_sampling: the reference's log10 constant-medium
        distance quirk (True: -1/density * log10(U); False: the standard
        ln). Both the staged path and the fused kernel obey it.
      use_pallas: the hand-written kernels, as the JAX config's flag selects
        its Pallas kernels. True: the staged path's closest hit runs the
        kernels K10-K12 on any device (on the CPU their forward is the
        plain version, their backward the winner's recompute); "auto":
        those kernels on CUDA, the plain brute force on the CPU; False: the
        plain brute force on any device, and `render_image` and
        `InverseRenderer` take the staged path instead of the fused
        megakernel. The fused megakernel runs on CUDA only.
    """

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 100
    max_depth: int = 50
    seed: int = 0
    ray_batch: int = 0
    t_min: float = 1e-3
    use_log10_volume_sampling: bool = True
    use_pallas: object = "auto"

    @classmethod
    def from_aspect(cls, width: int = 400, aspect_ratio: float = 16.0 / 9.0,
                    **kw) -> "RenderConfig":
        """Mirror of the reference CLI: height = round(width/aspect)."""
        height = int(round(width / aspect_ratio))
        return cls(width=width, height=height, **kw)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def n_rays(self) -> int:
        return self.width * self.height * self.samples_per_pixel
