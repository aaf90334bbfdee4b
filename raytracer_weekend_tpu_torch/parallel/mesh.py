"""The (rays, spp, geom) render mesh over torch.distributed ranks (port of
`parallel/mesh.py`).

Three named axes, as in the JAX package:

  rays - data parallelism over film pixels: each rays coordinate owns a
         contiguous block of pixels, and no collective runs until the
         frame is gathered;
  spp  - the samples of a pixel split into blocks, their sums added over
         the axis once at the end;
  geom - the sphere and triangle tables split into row slices: every
         bounce finds the closest hit over the axis (a gather of t and an
         argmin) and sums the owner's hit record to every coordinate.

JAX runs one process per host and its mesh spans that host's devices. The
port runs one process (a rank) per device under torch.distributed, so the
mesh is a grid over the world's ranks: rank k sits at the coordinate
(r, s, g) that C-order unravelling of k over the shape gives, as JAX's
`devices.reshape(shape)` lays devices out. Each rank holds its device and
the process groups of its spp axis (the ranks that share r and g) and of
its geom axis (the ranks that share r and s).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from raytracer_weekend_tpu_torch.ops.collectives import Axis


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A (rays, spp, geom) mesh and this rank's place in it."""

    shape: tuple[int, int, int]
    rank: int
    device: torch.device
    spp_group: object = None
    geom_group: object = None
    world_group: object = None
    ray_axis: str = "rays"
    spp_axis: str = "spp"
    geom_axis: str = "geom"

    @property
    def n_rays(self) -> int:
        return self.shape[0]

    @property
    def n_spp(self) -> int:
        return self.shape[1]

    @property
    def n_geom(self) -> int:
        return self.shape[2]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def coord(self) -> tuple[int, int, int]:
        """This rank's (r, s, g)."""
        return tuple(int(i) for i in np.unravel_index(self.rank, self.shape))

    @property
    def spp(self) -> Axis:
        return Axis(self.n_spp, self.coord[1], self.spp_group)

    @property
    def geom(self) -> Axis:
        return Axis(self.n_geom, self.coord[2], self.geom_group)

    @property
    def world(self) -> Axis:
        return Axis(self.size, self.rank, self.world_group)


def _mesh_device(device) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("make_render_mesh: torch sees no CUDA device; pass "
                           "device='cpu' to render on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_render_mesh(shape: tuple[int, int, int] | None = None,
                     device=None) -> RenderMesh:
    """Build a (rays, spp, geom) mesh over the world's ranks.

    Default: every rank on the rays axis, the right layout for a scene that
    fits on each device. A shape that needs more ranks than the world has
    raises, as the JAX `make_render_mesh` raises on too few devices; a shape
    that needs fewer raises too, with the world size in the message: JAX
    takes the first `need` devices of one process, but here a rank outside
    the mesh would have no work. With no process group initialised the
    world is this one rank.

    Every rank must call this with the same shape: it creates the spp and
    geom axes' process groups, and torch.distributed needs every rank to
    call `new_group` for every group, in the same order, even for the groups
    it is not in. The device is `cuda:{LOCAL_RANK % device_count}` unless
    `device` names one, or is "cpu"; where torch sees no card and the caller
    did not ask for the CPU, this raises.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world, 1, 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: want three positive sizes "
                         f"(rays, spp, geom)")
    need = int(np.prod(shape))
    if need != world:
        raise ValueError(f"mesh shape {shape} needs {need} ranks, the world "
                         f"size is {world}")
    device = _mesh_device(device)
    R, S, G = shape
    ids = np.arange(need).reshape(shape)
    spp_group = geom_group = None
    if S > 1:
        for r in range(R):
            for g in range(G):
                grp = dist.new_group([int(k) for k in ids[r, :, g]])
                if rank in ids[r, :, g]:
                    spp_group = grp
    if G > 1:
        for r in range(R):
            for s in range(S):
                grp = dist.new_group([int(k) for k in ids[r, s, :]])
                if rank in ids[r, s, :]:
                    geom_group = grp
    return RenderMesh(shape=shape, rank=rank, device=device,
                      spp_group=spp_group, geom_group=geom_group,
                      world_group=dist.group.WORLD if world > 1 else None)


def local_ranks(world_size=None) -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun sets it), else the
    world size given or in WORLD_SIZE (every rank on one host, the cautious
    reading), else 1."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size or
                              os.environ.get("WORLD_SIZE", 1)))


def choose_backend(device=None, local: int = 1) -> str:
    """nccl when each of this host's `local` ranks has a card of its own,
    else gloo (the CPU, or several ranks sharing one card: NCCL refuses two
    ranks on one device). A choice of transport: the render stays on the
    card."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available() or not dist.is_nccl_available():
        return "gloo"
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def distributed_init(device=None, timeout_s: float = 600.0, **kwargs) -> str:
    """`torch.distributed.init_process_group` with the backend
    `choose_backend` picks, printed on rank 0 with the ranks and cards it
    saw; `kwargs` (init_method, world_size, rank) pass through. `torchrun`
    sets the environment that `env://` reads. Returns the backend."""
    local = local_ranks(kwargs.get("world_size"))
    backend = choose_backend(device, local)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    dist.init_process_group(backend=backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    if dist.get_rank() == 0:
        where = ("device cpu" if device is not None
                 and torch.device(device).type == "cpu" else
                 f"{cards} CUDA devices")
        print(f"distributed_init: backend {backend} ({local} ranks on this "
              f"host, {where}), world size {dist.get_world_size()}",
              flush=True)
    return backend
