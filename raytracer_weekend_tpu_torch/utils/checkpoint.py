"""Tile-keyed render checkpoint and resume (port of `utils/checkpoint.py`).

A `TileStore` persists each finished (frame, tile) block of accumulated
color sums as a .npy file; `render_resumable` renders only the tiles
missing from the store, through the staged path (`integrator.render_chunk`)
on the scene's device, so a killed job resumes where it stopped. A tile's
sums stay on the device until the store writes them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


class TileStore:
    """Directory of .npy tiles keyed (frame, tile_index)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, frame: int, tile: int) -> str:
        return os.path.join(self.root, f"f{frame:04d}_t{tile:05d}.npy")

    def has(self, frame: int, tile: int) -> bool:
        return os.path.exists(self._path(frame, tile))

    def put(self, frame: int, tile: int, sums: np.ndarray) -> None:
        # .npy suffix on the temp name: np.save appends it otherwise.
        tmp = self._path(frame, tile) + ".tmp.npy"
        np.save(tmp, np.asarray(sums, np.float32))
        os.replace(tmp, self._path(frame, tile))  # atomic: crash-safe

    def get(self, frame: int, tile: int) -> np.ndarray:
        return np.load(self._path(frame, tile))

    def write_meta(self, **meta) -> None:
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump(meta, f)

    def read_meta(self) -> dict:
        path = os.path.join(self.root, "meta.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)


def render_resumable(scene, static, cfg, cam, store: TileStore,
                     frame: int = 0, tile_pixels: int = 4096,
                     progress=None) -> np.ndarray:
    """Render a frame tile by tile, skipping tiles already in the store ->
    (H, W, 3) accumulated color sums (numpy).

    Safe to re-run after a crash, and from several processes at once as
    long as they partition the tiles (writes are atomic). A store that
    holds another config raises.
    """
    from raytracer_weekend_tpu_torch import integrator

    meta = store.read_meta()
    key = dict(width=cfg.width, height=cfg.height,
               spp=cfg.samples_per_pixel, max_depth=cfg.max_depth,
               seed=cfg.seed)
    if meta and meta != key:
        raise ValueError(
            f"store {store.root} holds a different config {meta} != {key}")
    store.write_meta(**key)

    spp = cfg.samples_per_pixel
    n_pix = cfg.n_pixels
    n_tiles = -(-n_pix // tile_pixels)
    out = np.zeros((n_pix, 3), np.float32)

    for tile in range(n_tiles):
        start = tile * tile_pixels
        stop = min(start + tile_pixels, n_pix)
        if store.has(frame, tile):
            out[start:stop] = store.get(frame, tile)
        else:
            lanes = torch.arange(start * spp, stop * spp, dtype=torch.int64,
                                 device=scene.device)
            with torch.no_grad():
                colors = integrator.render_chunk(scene, static, cfg, cam,
                                                 lanes, cfg.seed)
            sums = colors.reshape(stop - start, spp, 3).sum(dim=1)
            out[start:stop] = sums.cpu().numpy()
            store.put(frame, tile, out[start:stop])
        if progress is not None:
            progress(tile + 1, n_tiles)
    return out.reshape(cfg.height, cfg.width, 3)
