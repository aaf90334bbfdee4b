"""Thin-lens look-at camera with defocus blur and a shutter interval.

Port of `raytracer_weekend_tpu/camera.py`, computed in float32 as the JAX
one is. `get_rays` is vectorized over a batch of film samples.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_weekend_tpu_torch import rng as rt_rng
from raytracer_weekend_tpu_torch.vecmath import cross, normalize


class Camera(NamedTuple):
    """Precomputed camera frame: (3,) vectors and () scalars, float32."""

    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in self))


def make_camera(
    look_from,
    look_at,
    up_vector=(0.0, 1.0, 0.0),
    vertical_field_of_view: float = 40.0,
    aspect_ratio: float = 16.0 / 9.0,
    aperture: float = 0.0,
    focus_dist: float = 10.0,
    time0: float = 0.0,
    time1: float = 1.0,
) -> Camera:
    """Construct the camera frame on the CPU (move it with `.to`)."""
    f32 = torch.float32
    look_from = torch.as_tensor(look_from, dtype=f32)
    look_at = torch.as_tensor(look_at, dtype=f32)
    up_vector = torch.as_tensor(up_vector, dtype=f32)

    theta = torch.tensor(vertical_field_of_view, dtype=f32) * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = normalize(look_from - look_at)
    u = normalize(cross(up_vector, w))
    v = cross(w, u)

    origin = look_from
    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

    return Camera(
        origin=origin,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=torch.tensor(aperture / 2.0, dtype=f32),
        time0=torch.tensor(time0, dtype=f32),
        time1=torch.tensor(time1, dtype=f32),
    )


def get_rays(cam: Camera, s: torch.Tensor, t: torch.Tensor, seed,
             ray_id: torch.Tensor):
    """Primary rays for film coordinates s, t (B,).

    Returns (origins (B,3), directions (B,3), times (B,)). Directions are
    not normalized, as in the reference: the hit tests work in units of |d|.
    """
    u_lens = rt_rng.rand4(seed, ray_id, 0, rt_rng.SALT_LENS)
    rd = cam.lens_radius * rt_rng.in_unit_disk_from_uniforms(
        u_lens[..., 0], u_lens[..., 1])
    offset = cam.u * rd[..., 0:1] + cam.v * rd[..., 1:2]

    u_time = rt_rng.rand4(seed, ray_id, 0, rt_rng.SALT_TIME)[..., 0]
    times = cam.time0 + u_time * (cam.time1 - cam.time0)

    origins = cam.origin + offset
    directions = (
        cam.lower_left
        + s[..., None] * cam.horizontal
        + t[..., None] * cam.vertical
        - cam.origin
        - offset
    )
    return origins, directions, times
