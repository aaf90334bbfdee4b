"""Vector math over trailing-axis-3 tensors (port of `vecmath.py`)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis -> (...,)."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product."""
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector; `eps` guards zero-length vectors."""
    return a / torch.sqrt(length_squared(a) + eps)[..., None]


def near_zero(a: torch.Tensor, s: float = 1e-8) -> torch.Tensor:
    """True where the vector is ~zero in all dimensions."""
    return torch.all(torch.abs(a) < s, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about normal n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, eta_i_over_eta_t) -> torch.Tensor:
    """Snell refraction of unit vector uv about unit normal n."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    eta = torch.as_tensor(eta_i_over_eta_t, dtype=cos_theta.dtype,
                          device=cos_theta.device)
    eta = torch.broadcast_to(eta, cos_theta.shape)
    r_out_perp = eta[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -torch.sqrt(torch.clamp_min(
            torch.abs(1.0 - length_squared(r_out_perp)), 1e-12))[..., None]
        * n
    )
    return r_out_perp + r_out_parallel


def ray_at(origin: torch.Tensor, direction: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    """Point along a ray: o + t*d."""
    return origin + t[..., None] * direction
