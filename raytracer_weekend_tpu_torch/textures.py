"""Table-driven textures evaluated over ray batches (port of `textures.py`).

The port evaluates the SOLID, CHECKER and UVDEBUG arms. NOISE and IMAGE
raise `NotImplementedError` until ROADMAP Queue 1 "Deferred textures" lands;
the table keeps all the JAX leaves so scenes convert one to one.

Types:
  0 SOLID    — constant color
  1 CHECKER  — 3D sine-product checker with frequency `scale`
  2 NOISE    — Perlin marble (not ported)
  3 IMAGE    — bitmap fetch (not ported)
  4 UVDEBUG  — (u, v, 0)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SOLID = 0
CHECKER = 1
NOISE = 2
IMAGE = 3
UVDEBUG = 4

_NOT_PORTED = ("noise and image textures are not ported yet "
               "(ROADMAP Queue 1, 'Deferred textures')")


class TextureTable(NamedTuple):
    """SoA texture bank. One row per texture instance in the scene."""

    ttype: torch.Tensor        # (K,)   int32 — type ids above
    color1: torch.Tensor       # (K,3)  f32   — solid color / checker even
    color2: torch.Tensor       # (K,3)  f32   — checker odd
    scale: torch.Tensor        # (K,)   f32   — checker frequency / noise scale
    image_id: torch.Tensor     # (K,)   int32 — row into the image atlas
    perlin_grad: torch.Tensor  # (256,3) f32  — shared Perlin gradient table
    perlin_perm: torch.Tensor  # (3,256) int32 — shared Perlin permutations
    images: torch.Tensor       # (I,H,W,3) f32 — image atlas
    image_hw: torch.Tensor     # (I,2)  int32 — (height, width) per image

    def to(self, device) -> "TextureTable":
        return TextureTable(*(t.to(device) for t in self))


def texture_value(table: TextureTable, tex_id: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor, p: torch.Tensor, *, has_noise: bool = False,
                  has_image: bool = False) -> torch.Tensor:
    """Evaluate per-lane texture color -> (B,3) (SOLID, CHECKER, UVDEBUG)."""
    if (has_noise or has_image
            or bool(((table.ttype == NOISE) | (table.ttype == IMAGE)).any())):
        raise NotImplementedError(_NOT_PORTED)
    tex_id = tex_id.long()
    ttype = table.ttype[tex_id]
    c1 = table.color1[tex_id]
    c2 = table.color2[tex_id]
    scale = table.scale[tex_id]

    # CHECKER: sines = prod sin(freq * p_axis); odd cell where < 0.
    sp = torch.sin(scale[..., None] * p)
    sines = sp[..., 0] * sp[..., 1] * sp[..., 2]
    checker = torch.where(sines[..., None] < 0.0, c2, c1)
    out = torch.where((ttype == CHECKER)[..., None], checker, c1)
    uvdbg = torch.stack([u, v, torch.zeros_like(u)], dim=-1)
    return torch.where((ttype == UVDEBUG)[..., None], uvdbg, out)
