"""Counter-based RNG (PCG4D) and closed-form samplers, in torch.

Port of `raytracer_weekend_tpu/rng.py`. Every sample is keyed on
(seed, ray_id, depth, salt), so the streams must be bit-exact with the JAX
package and with the CUDA kernel's device PCG4D (`csrc/pcg4d.cuh`).

torch's CPU `uint32` has no `+` and no `>>`, so the hash computes in int64
holding values in [0, 2^32). A 32x32-bit product can reach 2^64 and overflow
int64, so `_mul32` multiplies by 16-bit halves and keeps every partial
product below 2^48.
"""

from __future__ import annotations

import math

import torch

# Salts: one per RNG consumption site so streams never collide.
SALT_PIXEL_JITTER = 0x9E3779B1
SALT_LENS = 0x85EBCA77
SALT_TIME = 0xC2B2AE3D
SALT_LAMBERTIAN = 0x27D4EB2F
SALT_METAL = 0x165667B1
SALT_DIELECTRIC = 0xD3A2646C
SALT_ISOTROPIC = 0xFD7046C5
SALT_VOLUME = 0xB55A4F09  # + volume index

_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """int / tensor -> int64 tensor holding the value mod 2^32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    device = None if like is None else like.device
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), without int64 overflow."""
    lo = (a & 0xFFFF) * b                 # < 2^48
    hi = ((a >> 16) * b) & 0xFFFF         # only its low 16 bits survive << 16
    return (lo + (hi << 16)) & _M32


def pcg4d(x, y, z, w):
    """PCG4D mixing function: 4 x uint32 counters -> 4 x uint32 hashes.

    Jarzynski & Olano, "Hash Functions for GPU Rendering" (JCGT 2020). The
    counters are ints or integer tensors; the results are int64 tensors in
    [0, 2^32), equal to the JAX package's uint32 results.
    """
    like = next((t for t in (x, y, z, w) if isinstance(t, torch.Tensor)), None)
    v0, v1, v2, v3 = (_u32(t, like) for t in (x, y, z, w))
    # 1664525 < 2^21, so these products stay below 2^53.
    v0 = (v0 * 1664525 + 1013904223) & _M32
    v1 = (v1 * 1664525 + 1013904223) & _M32
    v2 = (v2 * 1664525 + 1013904223) & _M32
    v3 = (v3 * 1664525 + 1013904223) & _M32
    v0 = (v0 + _mul32(v1, v3)) & _M32
    v1 = (v1 + _mul32(v2, v0)) & _M32
    v2 = (v2 + _mul32(v0, v1)) & _M32
    v3 = (v3 + _mul32(v1, v2)) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + _mul32(v1, v3)) & _M32
    v1 = (v1 + _mul32(v2, v0)) & _M32
    v2 = (v2 + _mul32(v0, v1)) & _M32
    v3 = (v3 + _mul32(v1, v2)) & _M32
    return v0, v1, v2, v3


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 in [0, 1) using the top 24 bits (exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def rand4(seed, ray_id, depth, salt) -> torch.Tensor:
    """Four independent uniforms in [0,1) per lane, shape (..., 4).

    Keyed on (seed, ray_id, depth, salt): a lane draws the same numbers
    whatever the batch order or chunking.
    """
    b = pcg4d(ray_id, depth, salt, seed)
    return torch.stack([_to_unit_float(v) for v in b], dim=-1)


# ---------------------------------------------------------------------------
# Closed-form samplers (same distributions as the reference's rejection loops)
# ---------------------------------------------------------------------------

def unit_vector_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = _TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere_from_uniforms(u1: torch.Tensor, u2: torch.Tensor,
                                 u3: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball: radius is cbrt(u)."""
    direction = unit_vector_from_uniforms(u1, u2)
    radius = torch.pow(u3, 1.0 / 3.0)
    return direction * radius[..., None]


def in_unit_disk_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk, z=0."""
    r = torch.sqrt(u1)
    phi = _TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)
