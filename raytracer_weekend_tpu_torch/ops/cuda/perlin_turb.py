"""Perlin turbulence: kernel K8 (forward) and K9 (its VJP), and their plain twins.

Counterpart of `raytracer_weekend_tpu/ops/pallas/perlin_turb.py`. For
points p (..., 3) f32, the Perlin tables grad (256, 3) f32 and perm
(3, 256) int32, and an optional `live` (...,) bool mask:

  * `turbulence` returns |sum_k 0.5^k noise(2^k p)| (...,), 0 at dead
    points: kernel K8 (`csrc/perlin_turb.cu`) for CUDA tensors, the plain
    `perlin.turbulence` for CPU tensors;
  * `turbulence_vjp` returns (d_grad (256, 3), d_p (..., 3)) for a
    cotangent ct (...,): kernel K9 for CUDA tensors, torch autograd of the
    plain version for CPU tensors. Dead points get d_p 0 and add nothing to
    d_grad, whatever their cotangent;
  * `turbulence_diff` pairs the two as a `torch.autograd.Function`:
    gradients reach grad and p (perm holds integers).

A build, load or launch failure raises; nothing falls back to the plain
version on a card. The TPU kernel's (8, L) point planes, 16 x 16 nibble
tables and one-hot MXU lookups, bf16 hi/lo gradient split and tile-level
liveness gate are not carried over.
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch import perlin
from raytracer_weekend_tpu_torch.ops.cuda.megakernel import _check

# Launches of K8 and K9 in this process; only the launches in `turbulence`
# and `turbulence_vjp` add to them.
TURB_LAUNCHES = 0
TURB_VJP_LAUNCHES = 0


def turbulence_reference(grad, perm, p, depth: int = 7, live=None):
    """Plain version of K8: `perlin.turbulence`, 0 at dead points."""
    t = perlin.turbulence(grad, perm, p, depth)
    return t if live is None else torch.where(live, t, 0.0)


def turbulence_vjp_reference(grad, perm, p, ct, depth: int = 7, live=None):
    """Plain version of K9: torch autograd of `turbulence_reference`."""
    with torch.enable_grad():
        g = grad.detach().requires_grad_()
        q = p.detach().requires_grad_()
        t = turbulence_reference(g, perm, q, depth, live)
        d_grad, d_p = torch.autograd.grad(t, (g, q), grad_outputs=ct)
    return d_grad, d_p


def _args(grad, perm, p, live):
    """Flat, contiguous kernel operands, checked."""
    device = p.device
    n = p.numel() // 3
    pf = p.detach().reshape(n, 3).to(torch.float32).contiguous()
    g = grad.detach().to(torch.float32).contiguous()
    pm = perm.to(torch.int32).contiguous()
    _check(pf, torch.float32, (n, 3), device)
    _check(g, torch.float32, (perlin.POINT_COUNT, 3), device)
    _check(pm, torch.int32, (3, perlin.POINT_COUNT), device)
    lv = None
    if live is not None:
        lv = live.reshape(n).to(torch.bool).contiguous().view(torch.uint8)
        _check(lv, torch.uint8, (n,), device)
    return n, pf, g, pm, lv


def turbulence(grad, perm, p, depth: int = 7, live=None):
    """|sum_{k<depth} 0.5^k noise(2^k p)| at p (..., 3) -> (...,) f32, 0
    where `live` is False. K8 on a card, the plain version on the CPU."""
    global TURB_LAUNCHES
    if p.device.type == "cpu":
        return turbulence_reference(grad, perm, p, depth, live)
    if p.device.type != "cuda":
        raise NotImplementedError(f"no turbulence on {p.device}")
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    n, pf, g, pm, lv = _args(grad, perm, p, live)
    out = torch.empty((n,), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.rtw_turbulence(pf.data_ptr(),
                                 None if lv is None else lv.data_ptr(),
                                 g.data_ptr(), pm.data_ptr(), n, int(depth),
                                 out.data_ptr(), stream)
    _build.check(lib, err, "rtw_turbulence launch")
    TURB_LAUNCHES += 1
    return out.reshape(p.shape[:-1])


def turbulence_vjp(grad, perm, p, ct, depth: int = 7, live=None):
    """(d_grad (256, 3), d_p (..., 3)) of `turbulence` with cotangent ct
    (...,). K9 on a card, torch autograd of the plain version on the CPU."""
    global TURB_VJP_LAUNCHES
    if p.device.type == "cpu":
        return turbulence_vjp_reference(grad, perm, p, ct, depth, live)
    if p.device.type != "cuda":
        raise NotImplementedError(f"no turbulence VJP on {p.device}")
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    n, pf, g, pm, lv = _args(grad, perm, p, live)
    c = ct.detach().reshape(n).to(torch.float32).contiguous()
    _check(c, torch.float32, (n,), p.device)
    d_p = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    d_grad = torch.zeros((perlin.POINT_COUNT, 3), dtype=torch.float32,
                         device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.rtw_turbulence_vjp(
            pf.data_ptr(), c.data_ptr(), None if lv is None else lv.data_ptr(),
            g.data_ptr(), pm.data_ptr(), n, int(depth), d_p.data_ptr(),
            d_grad.data_ptr(), stream)
    _build.check(lib, err, "rtw_turbulence_vjp launch")
    TURB_VJP_LAUNCHES += 1
    return d_grad.to(grad.dtype), d_p.reshape(p.shape)


class _TurbDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad, perm, p, live, depth):
        ctx.depth = depth
        ctx.save_for_backward(grad, perm, p, live)
        return turbulence(grad, perm, p, depth, live)

    @staticmethod
    def backward(ctx, ct):
        grad, perm, p, live = ctx.saved_tensors
        d_grad, d_p = turbulence_vjp(grad, perm, p, ct, ctx.depth, live)
        return d_grad, None, d_p, None, None


def turbulence_diff(grad, perm, p, depth: int = 7, live=None):
    """Differentiable `turbulence`: K8 forward, K9 backward (their plain
    versions on the CPU). Gradients reach `grad` and `p`."""
    return _TurbDiff.apply(grad, perm, p, live, int(depth))
