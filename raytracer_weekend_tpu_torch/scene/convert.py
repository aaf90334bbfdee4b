"""Carry a scene between the JAX package and the port as numpy arrays.

The JAX package's `SceneData`, `SceneStatic` and `Camera` cross over as
plain containers of numpy arrays: each table is a mapping from field name to
array, or a sequence of arrays in field order (a NamedTuple whose leaves
were passed through `np.asarray` is such a sequence). Nothing here imports
jax, so the port can read scenes that were built elsewhere and saved.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.materials import MaterialTable
from raytracer_weekend_tpu_torch.ops.bvh import Bvh
from raytracer_weekend_tpu_torch.scene.data import (
    Rects, SceneData, SceneStatic, Spheres, Triangles, Volumes)
from raytracer_weekend_tpu_torch.textures import TextureTable

_TABLES = {
    "spheres": Spheres, "rects": Rects, "triangles": Triangles,
    "volumes": Volumes, "materials": MaterialTable, "textures": TextureTable,
}


def _table(cls, src):
    if isinstance(src, Mapping):
        values = [src[f] for f in cls._fields]
    else:
        values = list(src)
        if len(values) != len(cls._fields):
            raise ValueError(f"{cls.__name__}: expected {len(cls._fields)} "
                             f"arrays, got {len(values)}")
    return cls(*(torch.from_numpy(np.array(v, copy=True)) for v in values))


def _get(src, name: str, index: int):
    return src[name] if isinstance(src, Mapping) else src[index]


def scene_from_numpy(src) -> SceneData:
    """Mapping or sequence in `SceneData` field order -> port SceneData.

    The tree entries (`sphere_bvh`, `triangle_bvh`) are absent or None for
    no tree, else a table of `Bvh`'s four fields.
    """
    fields = SceneData._fields
    kw = {name: _table(cls, _get(src, name, fields.index(name)))
          for name, cls in _TABLES.items()}
    for name in ("sphere_bvh", "triangle_bvh"):
        i = fields.index(name)
        tree = (src.get(name) if isinstance(src, Mapping)
                else (src[i] if len(src) > i else None))
        kw[name] = None if tree is None else _table(Bvh, tree)
    bg = _get(src, "background", fields.index("background"))
    return SceneData(background=torch.from_numpy(np.array(bg, np.float32)),
                     **kw)


def static_from_dict(src) -> SceneStatic:
    """Mapping of `SceneStatic` fields (e.g. `dataclasses.asdict`) -> port."""
    return SceneStatic(**{f.name: src[f.name]
                          for f in dataclasses.fields(SceneStatic)})


def camera_from_numpy(src) -> Camera:
    """Mapping or sequence in `Camera` field order -> port Camera."""
    return _table(Camera, src)


def scene_to_numpy(scene: SceneData) -> dict:
    """Port SceneData -> dict of dicts of numpy arrays (CPU copies); a tree
    slot holds None where the scene has no tree."""
    out = {name: {f: getattr(scene, name)._asdict()[f].detach().cpu().numpy()
                  for f in cls._fields}
           for name, cls in _TABLES.items()}
    out["background"] = scene.background.detach().cpu().numpy()
    for name in ("sphere_bvh", "triangle_bvh"):
        tree = getattr(scene, name)
        out[name] = None if tree is None else {
            f: x.detach().cpu().numpy() for f, x in tree._asdict().items()}
    return out


def camera_to_numpy(cam: Camera) -> dict:
    return {f: t.detach().cpu().numpy() for f, t in cam._asdict().items()}


def grads_from_numpy(like: SceneData, scene_grads, cam_grads=None):
    """A JAX gradient -> the port's SceneData/Camera structure.

    `scene_grads` are the JAX scene gradient's float leaves as numpy arrays,
    in `tree_leaves` order with the `float0` leaves (the gradients of
    integer and bool leaves) dropped; `like` is the port scene they belong
    to. `cam_grads` is the JAX camera gradient, a mapping or sequence in
    `Camera` field order (every camera leaf is float). Returns (SceneData
    with a tensor at every float leaf of `like` and None elsewhere, Camera
    or None), so the two packages' gradients compare leaf by leaf.
    """
    like_leaves = like.leaves()
    scene_grads = list(scene_grads)
    n_float = sum(t.is_floating_point() for t in like_leaves)
    if len(scene_grads) != n_float:
        raise ValueError(f"{len(scene_grads)} gradient leaves for the "
                         f"{n_float} float leaves of the scene")
    grads = iter(scene_grads)
    leaves = [torch.from_numpy(np.array(next(grads), np.float32))
              if t.is_floating_point() else None for t in like_leaves]
    cam = None if cam_grads is None else camera_from_numpy(cam_grads)
    return SceneData.from_leaves(leaves, like.trees), cam
