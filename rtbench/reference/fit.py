"""The plain reference of a fit step: the L2 loss of a frame against a
target image and its gradient over every float table of the reference
(`render.Tables`), by torch autograd through `render.render_lanes`, and
Adam's update in float64.

The loss is the program's: mean over pixels and channels of (img -
target)^2, img the mean over the pixel's `spp` samples. It is computed in
two passes over lane blocks, so that the brute force and its autograd fit:
the first renders the frame without a graph and gives the loss and its
cotangent a pixel; the second renders each block again under autograd and
pulls that cotangent back to the tables.

Discrete choices (the hit, reflect or refract, the checker's cell, the
texel a (u, v) falls in) come out of comparisons and integer indices, so
autograd holds them fixed and differentiates the continuous factors. The
image fetch is nearest, as in the program: a texel has a gradient, (u, v)
none. That is a departure from a continuous texture, not a tolerance.
"""

from __future__ import annotations

import torch

from rtbench.reference import render as R

BETAS = (0.9, 0.999)
EPS = 1e-8


def float_fields(T: R.Tables) -> list[str]:
    """The reference's float tables: what a fit differentiates."""
    return [f for f in T._fields if getattr(T, f).is_floating_point()]


def _block(T: R.Tables, grad: bool) -> int:
    """Lanes a block: the brute force makes (lanes, rows) tensors, and
    under autograd holds a few of them a bounce."""
    rows = max(T.radius.shape[0], T.rk.shape[0], T.tmat.shape[0], 1)
    return max(1024, min(1 << (18 if grad else 20),
                         (1 << (23 if grad else 25)) // rows))


def frame(T: R.Tables, cam: dict, width: int, height: int, spp: int,
          max_depth: int, seed: int, *, log10: bool = True,
          block: int | None = None) -> torch.Tensor:
    """The mean radiance (H, W, 3), float32, of the whole frame."""
    block = block or _block(T, grad=False)
    n = width * height * spp
    dev = T.c0.device
    out = []
    with torch.no_grad():
        for s in range(0, n, block):
            lanes = torch.arange(s, min(s + block, n), device=dev)
            rad, _ = R.render_lanes(T, cam, width, height, spp, max_depth,
                                    lanes, seed, log10=log10)
            out.append(rad.float())
    return (torch.cat(out).reshape(height * width, spp, 3).sum(1) / spp
            ).reshape(height, width, 3)


def loss_and_grad(T: R.Tables, cam: dict, width: int, height: int, spp: int,
                  max_depth: int, target: torch.Tensor, seed: int, *,
                  log10: bool = True, block: int | None = None):
    """(loss, {field: gradient}) of the frame rendered from `seed` against
    `target` (H, W, 3), the gradient over every float table of `T`."""
    img = frame(T, cam, width, height, spp, max_depth, seed, log10=log10)
    target = target.to(img.device, torch.float32)
    diff = (img - target).double()
    loss = float((diff * diff).mean())
    # d loss / d (a lane's radiance): 2 (img - target) / (H W 3) / spp.
    cot = (2.0 * diff / (diff.numel() * spp)).float().reshape(-1, 3)
    leaves = {f: getattr(T, f).detach().clone().requires_grad_()
              for f in float_fields(T)}
    Tg = T._replace(**leaves)
    n = width * height * spp
    block = block or _block(T, grad=True)
    for s in range(0, n, block):
        lanes = torch.arange(s, min(s + block, n), device=img.device)
        rad, _ = R.render_lanes(Tg, cam, width, height, spp, max_depth,
                                lanes, seed, log10=log10)
        (rad.float() * cot[torch.div(lanes, spp, rounding_mode="floor")]
         ).sum().backward()
    grads = {f: (t.grad if t.grad is not None else torch.zeros_like(t))
             for f, t in leaves.items()}
    return loss, grads


def adam_step(m: torch.Tensor, v: torch.Tensor, step: int, g: torch.Tensor,
              lr: float, betas=BETAS, eps: float = EPS) -> torch.Tensor:
    """Adam's update of one tensor from its state (m, v after `step`
    steps) with gradient g, in float64 -> the parameter's change."""
    b1, b2 = betas
    m, v, g = (x.double() for x in (m, v, g))
    t = step + 1
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return -lr * m_hat / (v_hat.sqrt() + eps)
