"""Scene serialization: SceneData + SceneStatic <-> one .npz file (port of
`scene/io.py`).

The keys are the JAX package's: `<table>.<field>` for every table, the
trees as `sphere_bvh.<field>` and `triangle_bvh.<field>` where present,
`background`, and `static_json` (the SceneStatic fields as JSON bytes), so
a file saved by either package loads in the other. It is the checkpoint
format of inverse-rendering runs and a faster cold start than re-parsing
OBJ assets.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from raytracer_weekend_tpu_torch.materials import MaterialTable
from raytracer_weekend_tpu_torch.ops.bvh import Bvh
from raytracer_weekend_tpu_torch.scene.data import (
    Rects, SceneData, SceneStatic, Spheres, Triangles, Volumes)
from raytracer_weekend_tpu_torch.textures import TextureTable

_TABLES = {
    "spheres": Spheres,
    "rects": Rects,
    "triangles": Triangles,
    "volumes": Volumes,
    "materials": MaterialTable,
    "textures": TextureTable,
}
_TREES = ("sphere_bvh", "triangle_bvh")


def save_scene(path: str, scene: SceneData, static: SceneStatic) -> None:
    """Write `scene` (from any device) and `static` to `path` (.npz)."""
    def host(x):
        return x.detach().cpu().numpy()

    arrays: dict[str, np.ndarray] = {}
    for name, cls in _TABLES.items():
        table = getattr(scene, name)
        for field in cls._fields:
            arrays[f"{name}.{field}"] = host(getattr(table, field))
    arrays["background"] = host(scene.background)
    for name in _TREES:
        tree = getattr(scene, name)
        if tree is not None:
            for field in Bvh._fields:
                arrays[f"{name}.{field}"] = host(getattr(tree, field))
    arrays["static_json"] = np.frombuffer(
        json.dumps(dataclasses.asdict(static)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_scene(path: str, device="cuda") -> tuple[SceneData, SceneStatic]:
    """Read a scene saved by either package -> (SceneData on `device`,
    SceneStatic). The default is the card, as `generate_scene`'s: with no
    CUDA device this raises unless the caller asks for `device="cpu"`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_scene({path!r}) on {device}: torch sees no "
                           f"CUDA device; pass device='cpu' for the CPU")
    with np.load(path) as z:
        def tensor(key):
            return torch.from_numpy(np.array(z[key])).to(device)

        def tree(name):
            if f"{name}.bmin" not in z:
                return None
            return Bvh(*[tensor(f"{name}.{f}") for f in Bvh._fields])

        scene = SceneData(
            **{name: cls(*[tensor(f"{name}.{f}") for f in cls._fields])
               for name, cls in _TABLES.items()},
            background=tensor("background"),
            **{name: tree(name) for name in _TREES})
        static = SceneStatic(**json.loads(bytes(z["static_json"]).decode()))
    return scene, static
