"""Rendering across hosts over torch.distributed (port of
`parallel/multihost.py`).

A single-host mesh renders through `parallel.shard` directly; across hosts
the same shard body runs over a mesh of every rank of every host, and the
frame comes back to every rank. One process per device, on every host:

    init_multihost(coordinator_address="host0:1234",
                   num_processes=N, process_id=i)
    img = render_multihost(scene, static, cfg, cam)   # full frame, all ranks

The JAX package puts the scene on every device as a replicated global array
(`_replicate`); here every rank builds or loads the same scene itself, so
that function has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raytracer_weekend_tpu_torch.parallel.mesh import (
    RenderMesh, distributed_init, make_render_mesh)
from raytracer_weekend_tpu_torch.parallel.shard import render_sharded


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, **kw) -> str:
    """Join the world: `init_process_group` over TCP at the coordinator's
    address ("host:port", served by process 0), with this process's rank
    (`mesh.distributed_init` picks and prints the backend). Returns it."""
    return distributed_init(init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def global_render_mesh(shape: Optional[tuple[int, int, int]] = None,
                       device=None) -> RenderMesh:
    """A (rays, spp, geom) mesh over every rank of every host, rays leading
    so that film blocks ride hosts (the frame crosses hosts once). Its size
    must be the world's (`make_render_mesh` raises otherwise)."""
    return make_render_mesh(shape, device=device)


def render_multihost(scene, static, cfg, cam,
                     rmesh: Optional[RenderMesh] = None,
                     seed: Optional[int] = None) -> np.ndarray:
    """Full-frame render across every rank -> (H, W, 3) color sums as a
    numpy array, identical on every rank (and to the single-device render,
    up to the order of an spp axis's sum)."""
    rmesh = rmesh or global_render_mesh(device=scene.device)
    with torch.no_grad():
        sums = render_sharded(scene, static, cfg, cam, rmesh, seed)
    return sums.cpu().numpy()
