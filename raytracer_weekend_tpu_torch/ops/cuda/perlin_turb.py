"""Perlin turbulence: kernel K8 (forward) and K9 (its VJP), and their plain twins.

Counterpart of `raytracer_weekend_tpu/ops/pallas/perlin_turb.py`. For
points p (..., 3) f32, the Perlin tables grad (256, 3) f32 and perm
(3, 256) int32, and an optional `live` (...,) bool mask:

  * `turbulence` returns |sum_k 0.5^k noise(2^k p)| (...,), 0 at dead
    points: kernel K8 (`csrc/perlin_turb.cu`) for CUDA tensors, the plain
    `perlin.turbulence` for CPU tensors;
  * `turbulence_vjp` returns (d_grad (256, 3), d_p (..., 3)) for a
    cotangent ct (...,): kernel K9 for CUDA tensors, torch autograd of the
    plain version for CPU tensors. Dead points get d_p 0 and add nothing
    to d_grad, whatever their cotangent;
  * `turbulence_diff` pairs the two as a `torch.autograd.Function`:
    gradients reach grad and p (perm holds integers).

Both kernels run persistent warps that claim windows of points, write 0
for the dead ones and pack the live ones by ballot into full batches of
32; `live_claim_order` is the plain twin of that work order, and
`turbulence_twin` and `turbulence_vjp_twin` run the plain versions batch
by batch in it.

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

# The work order of K8 and K9, csrc/perlin_turb.cu's kTurbBlock,
# kTurbWindow, kVjpBlock and kVjpWindow: threads a block, and points a warp
# claims at once.
TURB_BLOCK = 256
TURB_WINDOW = 128
VJP_BLOCK = 256
VJP_WINDOW = 128


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


def _ptr(x):
    return None if x is None else x.data_ptr()


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


def turbulence_operands(grad, perm, p, live=None):
    """K8's operands, checked, its output buffer and its claim counter:
    the argument of `_launch_turbulence` (build it once to time the launch
    alone)."""
    n, pf, g, pm, lv = _args(grad, perm, p, live)
    out = torch.empty((n,), dtype=torch.float32, device=p.device)
    return dict(n=n, p=pf, live=lv, grad=g, perm=pm, out=out,
                next=torch.empty((1,), dtype=torch.int32, device=p.device))


def _launch_turbulence(ops, depth: int = 7):
    """One launch of K8 on `turbulence_operands`; returns ops["out"]."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    device = ops["p"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_turbulence(
            ops["p"].data_ptr(), _ptr(ops["live"]), ops["grad"].data_ptr(),
            ops["perm"].data_ptr(), ops["n"], int(depth),
            ops["out"].data_ptr(), ops["next"].data_ptr(), stream)
    _build.check(lib, err, "rtw_turbulence launch")
    return ops["out"]


def turbulence(grad, perm, p, depth: int = 7, live=None):
    """|sum_{k<depth} 0.5^k noise(2^k p)| at p (..., 3) -> (...,) f32, 0
    where `live` is False. K8 on a card, the plain version on the CPU."""
    global TURB_LAUNCHES
    if p.device.type == "cpu":
        return turbulence_reference(grad, perm, p, depth, live)
    if p.device.type != "cuda":
        raise NotImplementedError(f"no turbulence on {p.device}")
    out = _launch_turbulence(turbulence_operands(grad, perm, p, live), depth)
    TURB_LAUNCHES += 1
    return out.reshape(p.shape[:-1])


def vjp_operands(grad, perm, p, ct, live=None):
    """K9's operands, checked, its outputs (d_p, and d_grad zeroed) and its
    claim counter: the argument of `_launch_vjp` (build it once to time the
    launch alone; each launch adds into d_grad)."""
    n, pf, g, pm, lv = _args(grad, perm, p, live)
    c = ct.detach().reshape(n).to(torch.float32).contiguous()
    _check(c, torch.float32, (n,), p.device)
    return dict(n=n, p=pf, ct=c, live=lv, grad=g, perm=pm,
                d_p=torch.empty((n, 3), dtype=torch.float32, device=p.device),
                d_grad=torch.zeros((perlin.POINT_COUNT, 3),
                                   dtype=torch.float32, device=p.device),
                next=torch.empty((1,), dtype=torch.int32, device=p.device))


def _launch_vjp(ops, depth: int = 7):
    """One launch of K9 on `vjp_operands` -> (d_grad, d_p) of ops."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    device = ops["p"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_turbulence_vjp(
            ops["p"].data_ptr(), ops["ct"].data_ptr(), _ptr(ops["live"]),
            ops["grad"].data_ptr(), ops["perm"].data_ptr(), ops["n"],
            int(depth), ops["d_p"].data_ptr(), ops["d_grad"].data_ptr(),
            ops["next"].data_ptr(), stream)
    _build.check(lib, err, "rtw_turbulence_vjp launch")
    return ops["d_grad"], ops["d_p"]


def turbulence_vjp(grad, perm, p, ct, depth: int = 7, live=None):
    """(d_grad (256, 3), d_p (..., 3)) of `turbulence` with cotangent ct
    (...,). K9 on a card, torch autograd of the plain version on the CPU."""
    global TURB_VJP_LAUNCHES
    if p.device.type == "cpu":
        return turbulence_vjp_reference(grad, perm, p, ct, depth, live)
    if p.device.type != "cuda":
        raise NotImplementedError(f"no turbulence VJP on {p.device}")
    d_grad, d_p = _launch_vjp(vjp_operands(grad, perm, p, ct, live), depth)
    TURB_VJP_LAUNCHES += 1
    return d_grad.to(grad.dtype), d_p.reshape(p.shape)


def live_claim_order(live, warps: int, window: int = VJP_WINDOW,
                     seed: int = 0):
    """Plain twin of the work order of K8 and K9 (`for_live_points` in
    csrc/perlin_turb.cu) over the points whose mask is `live` (n,) bool ->
    (batches, dead).

    `warps` warps take turns in a random order each round (`seed`), as
    resident warps interleave on the card. A turn claims the next `window`
    points from a shared counter and scans them 32 at a time: dead points
    are written 0 at once, live ones join the warp's queue in index order,
    and whenever the queue holds 32 the warp runs them as one batch, a
    point a lane. A warp whose claim passes the end runs what its queue
    holds and leaves. `batches` lists (warp, points (<= 32,) int64) in the
    order they ran; `dead` (n_dead,) int64 the dead points in the order
    they were written."""
    flags = live.reshape(-1).tolist()
    n = len(flags)
    gen = torch.Generator().manual_seed(seed)
    queue = [[] for _ in range(warps)]
    active = list(range(warps))
    batches, dead, nxt = [], [], 0
    while active:
        for w in [active[i] for i in torch.randperm(len(active),
                                                    generator=gen)]:
            base, nxt = nxt, nxt + window
            if base >= n:
                if queue[w]:
                    batches.append((w, torch.tensor(queue[w])))
                active.remove(w)
                continue
            for j in range(base, min(base + window, n)):
                (queue[w] if flags[j] else dead).append(j)
                if (j - base) % 32 == 31 and len(queue[w]) >= 32:
                    batches.append((w, torch.tensor(queue[w][:32])))
                    del queue[w][:32]
            if len(queue[w]) >= 32:     # the window's last, partial chunk
                batches.append((w, torch.tensor(queue[w][:32])))
                del queue[w][:32]
    return batches, torch.tensor(dead, dtype=torch.int64)


def turbulence_vjp_twin(grad, perm, p, ct, depth: int = 7, live=None,
                        warps: int = 4, seed: int = 0):
    """K9's plain twin in its work order (`live_claim_order`): the plain VJP
    of each batch of live points, d_p written at their indices and 0 at the
    dead points, d_grad summed batch by batch -> (d_grad, d_p) as
    `turbulence_vjp`. Each batch runs at its points' own places in the
    array (the others masked dead): torch's vectorized CPU kernels round a
    point's operations by its place in a tensor, up to an ulp apart."""
    n = p.numel() // 3
    pf, c = p.reshape(n, 3), ct.reshape(n)
    lv = (torch.ones(n, dtype=torch.bool) if live is None
          else live.reshape(n))
    batches, dead = live_claim_order(lv, warps, seed=seed)
    d_p = torch.full((n, 3), float("nan"), dtype=pf.dtype)
    d_p[dead] = 0.0
    d_grad = torch.zeros_like(grad)
    for _, idx in batches:
        mine = torch.zeros(n, dtype=torch.bool)
        mine[idx] = True
        dg, dp = turbulence_vjp_reference(grad, perm, pf, c, depth, mine)
        d_p[idx] = dp[idx]
        d_grad = d_grad + dg
    return d_grad, d_p.reshape(p.shape)


def turbulence_twin(grad, perm, p, depth: int = 7, live=None,
                    warps: int = 4, window: int = TURB_WINDOW, seed: int = 0):
    """K8's plain twin in its work order (`live_claim_order`): the plain
    turbulence of each batch of live points written at their indices, 0 at
    the dead points -> (...,) as `turbulence`. Each batch runs at its
    points' own places in the array (the others masked dead), as
    `turbulence_vjp_twin` does."""
    n = p.numel() // 3
    pf = p.reshape(n, 3)
    lv = (torch.ones(n, dtype=torch.bool) if live is None
          else live.reshape(n))
    batches, dead = live_claim_order(lv, warps, window, seed=seed)
    out = torch.full((n,), float("nan"), dtype=pf.dtype)
    out[dead] = 0.0
    for _, idx in batches:
        mine = torch.zeros(n, dtype=torch.bool)
        mine[idx] = True
        out[idx] = turbulence_reference(grad, perm, pf, depth, mine)[idx]
    return out.reshape(p.shape[:-1])


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
