"""Table-driven textures evaluated over ray batches (port of `textures.py`).

A scene carries one `TextureTable` (SoA) and evaluation is a branchless
per-lane select over the texture type id. Every field (colors, noise
scale, Perlin gradients, texels) is a differentiable leaf.

Types:
  0 SOLID    — constant color
  1 CHECKER  — 3D sine-product checker with frequency `scale`
  2 NOISE    — Perlin marble 0.5 * (1 + sin(scale * z + 10 * turb))
  3 IMAGE    — bitmap fetch: clamp UV, flip V, nearest texel (the texels
               were divided by 255 when the atlas was built); a bilinear
               mode gives gradients with respect to (u, v)
  4 UVDEBUG  — (u, v, 0)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from raytracer_weekend_tpu_torch import perlin

SOLID = 0
CHECKER = 1
NOISE = 2
IMAGE = 3
UVDEBUG = 4


class TextureTable(NamedTuple):
    """SoA texture bank. One row per texture instance in the scene."""

    ttype: torch.Tensor        # (K,)   int32 — type ids above
    color1: torch.Tensor       # (K,3)  f32   — solid color / checker even
    color2: torch.Tensor       # (K,3)  f32   — checker odd
    scale: torch.Tensor        # (K,)   f32   — checker frequency / noise scale
    image_id: torch.Tensor     # (K,)   int32 — row into the image atlas
    perlin_grad: torch.Tensor  # (256,3) f32  — shared Perlin gradient table
    perlin_perm: torch.Tensor  # (3,256) int32 — shared Perlin permutations
    images: torch.Tensor       # (I,H,W,3) f32 — image atlas (padded to max H,W)
    image_hw: torch.Tensor     # (I,2)  int32 — (height, width) per image

    def to(self, device) -> "TextureTable":
        return TextureTable(*(t.to(device) for t in self))


def _turbulence(grad, perm, p, live):
    """The default turbulence of the noise arm: the plain `perlin` one,
    which evaluates every point (dead ones are masked by the caller)."""
    return perlin.turbulence(grad, perm, p, depth=7)


def texture_value(table: TextureTable, tex_id: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor, p: torch.Tensor, *, has_noise: bool = True,
                  has_image: bool = True, bilinear: bool = False,
                  noise_fn: Optional[Callable] = None,
                  live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate per-lane texture color -> (..., 3).

    `has_noise`/`has_image` (from SceneStatic) skip the noise and image arms
    for scenes without them; a row of that type then reads its color1.
    `noise_fn(grad, perm, p, live)` computes the 7-octave turbulence at p
    (..., 3) -> (...,): the plain `perlin.turbulence` by default, the
    kernel-backed `ops.cuda.perlin_turb.turbulence_diff` in the deferred
    combine. `live` (...,) bool marks the points whose value is used; the
    noise arm passes `live & is_noise` to `noise_fn`, which may skip the
    others.
    """
    tex_id = tex_id.long()
    ttype = _rows(table.ttype, tex_id)
    c1 = _rows(table.color1, tex_id)
    c2 = _rows(table.color2, tex_id)
    scale = _rows(table.scale, tex_id)

    # CHECKER: sines = prod sin(freq * p_axis); odd cell where < 0.
    sp = torch.sin(scale[..., None] * p)
    sines = sp[..., 0] * sp[..., 1] * sp[..., 2]
    checker = torch.where(sines[..., None] < 0.0, c2, c1)
    out = torch.where((ttype == CHECKER)[..., None], checker, c1)

    if has_noise:
        is_noise = ttype == NOISE
        lv = is_noise if live is None else (live & is_noise)
        turb = (noise_fn or _turbulence)(table.perlin_grad,
                                         table.perlin_perm, p, lv)
        marble = 0.5 * (1.0 + torch.sin(scale * p[..., 2] + 10.0 * turb))
        out = torch.where(is_noise[..., None], marble[..., None].expand_as(out),
                          out)

    if has_image:
        img = _image_fetch(table, _rows(table.image_id, tex_id), u, v,
                           bilinear=bilinear)
        out = torch.where((ttype == IMAGE)[..., None], img, out)

    uvdbg = torch.stack([u, v, torch.zeros_like(u)], dim=-1)
    return torch.where((ttype == UVDEBUG)[..., None], uvdbg, out)


_SELECT_ROWS = 8


def _rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] for an index tensor of any shape.

    A deferred combine's millions of records read the same few texture
    rows. The backward of `tab[idx]` sorts the indices and adds the
    duplicates of a row one after another (seconds for a frame's records
    on an H100), and that of `index_select`, an atomic `index_add_`, piles
    every record onto the same few addresses (chip_smoke.py phase 10 times
    it against the selects). So a table of at most `_SELECT_ROWS` rows is
    read by one select per row, whose backward is a plain sum per row, and
    a larger one (the image atlas, whose texels the records spread over)
    by `index_select`.
    """
    flat = idx.reshape(-1)
    if tab.shape[0] <= _SELECT_ROWS:
        out = tab[0].expand(flat.shape[0], *tab.shape[1:])
        for k in range(1, tab.shape[0]):
            hit = (flat == k).reshape(-1, *([1] * (tab.dim() - 1)))
            out = torch.where(hit, tab[k], out)
    else:
        out = torch.index_select(tab, 0, flat)
    return out.reshape(*idx.shape, *tab.shape[1:])


def _image_fetch(table: TextureTable, img_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, *, bilinear: bool = False) -> torch.Tensor:
    """Texel fetch from the atlas -> (..., 3).

    Nearest mode is image_texture.rs parity: clamp (u, v) to [0, 1], flip v,
    truncate to a texel, clamp to the edge. Bilinear mode samples at texel
    centers with clamp-to-edge and is smooth in (u, v), the form a fit of
    geometry through an image texel would need; no scene or path of the
    package sets it yet (the JAX `texture_value` has it too).
    """
    n_img, ph, pw = table.images.shape[0:3]
    img_id = img_id.long()
    hw = _rows(table.image_hw, img_id).to(torch.float32)
    h, w = hw[..., 0], hw[..., 1]
    h_max = (h - 1).to(torch.int64)
    w_max = (w - 1).to(torch.int64)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)
    flat = table.images.reshape(n_img * ph * pw, 3)

    def fetch(j, i):
        return _rows(flat, (img_id * ph + j) * pw + i)

    def clip(x, hi):
        return torch.minimum(torch.clamp_min(x, 0), hi)

    if not bilinear:
        i = clip((uc * w).to(torch.int64), w_max)
        j = clip((vc * h).to(torch.int64), h_max)
        return fetch(j, i)

    x = uc * w - 0.5
    y = vc * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = clip(x0.to(torch.int64), w_max)
    yi0 = clip(y0.to(torch.int64), h_max)
    xi1 = clip(xi0 + 1, w_max)
    yi1 = clip(yi0 + 1, h_max)
    top = fetch(yi0, xi0) * (1.0 - fx) + fetch(yi0, xi1) * fx
    bot = fetch(yi1, xi0) * (1.0 - fx) + fetch(yi1, xi1) * fx
    return top * (1.0 - fy) + bot * fy
