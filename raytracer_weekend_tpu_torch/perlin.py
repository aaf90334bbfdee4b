"""Perlin noise over batches of 3D points (port of `perlin.py`).

256 random unit gradients plus three independent permutation tables. The
lattice hash is the XOR of the per-axis permutations at `floor(p) + offset
& 255`, the interpolation is Hermite-smoothed trilinear over gradient dots,
and turbulence sums |sum_k 0.5^k noise(2^k p)|.

Reference quirk kept for parity: the Hermite filter is applied to the
cell-local point *before* computing both the blend factor and the gradient
offset vector `weight_v`, unlike the book, which uses the unfiltered point
for `weight_v`. The corner order (i-major over x, y, z) and the summation
order are the JAX package's. Lattice indices are int64 (torch has no
uint32 arithmetic on the CPU, as in `rng.py`); the `& 255` wrap gives the
same cell as the JAX int32 form for every |p| < 2^31.

This is the plain version of kernel K8 (`ops/cuda/perlin_turb.py`), and its
autograd the plain version of K9.
"""

from __future__ import annotations

import numpy as np
import torch

POINT_COUNT = 256

# The 8 lattice-cell corner offsets, in (x, y, z).
_CORNERS = np.array(
    [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
    dtype=np.int64,
)  # (8, 3)


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


def noise(gradients: torch.Tensor, perms: torch.Tensor,
          p: torch.Tensor) -> torch.Tensor:
    """Perlin noise at points p (..., 3) -> (...,)."""
    pf = torch.floor(p)
    base = pf.to(torch.int64)                 # (..., 3)
    frac = p - pf                              # (..., 3) in [0, 1)

    corners = torch.from_numpy(_CORNERS).to(p.device)          # (8, 3)
    lattice = (base[..., None, :] + corners) & (POINT_COUNT - 1)
    perms = perms.to(torch.int64)
    h = (perms[0][lattice[..., 0]] ^ perms[1][lattice[..., 1]]
         ^ perms[2][lattice[..., 2]]) & (POINT_COUNT - 1)
    # An index_select: its backward adds with atomics, where that of
    # gradients[h] sorts millions of indices into 256 rows.
    grad = torch.index_select(gradients, 0, h.reshape(-1)).reshape(
        *h.shape, 3)                           # (..., 8, 3)

    # Hermite smoothing, applied before the blend and the offset vectors.
    u = frac * frac * (3.0 - 2.0 * frac)       # (..., 3)
    cf = corners.to(p.dtype)
    weight_v = u[..., None, :] - cf            # (..., 8, 3)
    blend = torch.prod(cf * u[..., None, :] + (1.0 - cf) * (1.0 - u[..., None, :]),
                       dim=-1)                 # (..., 8)
    return torch.sum(blend * torch.sum(grad * weight_v, dim=-1), dim=-1)


def turbulence(gradients: torch.Tensor, perms: torch.Tensor, p: torch.Tensor,
               depth: int = 7) -> torch.Tensor:
    """|sum_k 0.5^k noise(2^k p)|, (..., 3) -> (...,)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise(gradients, perms, temp_p)
        weight *= 0.5
        temp_p = temp_p * 2.0
    return torch.abs(accum)
