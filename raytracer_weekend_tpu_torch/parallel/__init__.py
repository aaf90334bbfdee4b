"""Parallel and streaming front ends of the port: the (rays, spp, geom)
render mesh over torch.distributed (`mesh`, `shard`, `multihost`) and the
pixel stream (`stream`)."""

from raytracer_weekend_tpu_torch.parallel.mesh import (
    RenderMesh, make_render_mesh)
from raytracer_weekend_tpu_torch.parallel.shard import (
    render_image_sharded, render_sharded, train_step)

__all__ = [
    "RenderMesh",
    "make_render_mesh",
    "render_sharded",
    "render_image_sharded",
    "train_step",
]
