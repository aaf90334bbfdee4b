"""Perlin tables (port of `perlin.make_perlin_tables` only).

The noise and turbulence functions wait for ROADMAP Queue 1 "Deferred
textures"; the tables are built here so that the texture table carries the
same leaves as the JAX package's.
"""

from __future__ import annotations

import numpy as np

POINT_COUNT = 256


def make_perlin_tables(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Gradient (256,3) f32 and permutation (3,256) int32 tables.

    Gradients are random points in [-1,1)^3 normalized to unit length;
    permutations are three independent shuffles of 0..255.
    """
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    perms = np.stack(
        [rng.permutation(POINT_COUNT) for _ in range(3)]
    ).astype(np.int32)
    return g, perms
