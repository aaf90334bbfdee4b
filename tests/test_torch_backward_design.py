"""The turbulence kernels' and the backward kernels' work orders (K8 and K9
in csrc/perlin_turb.cu, K7 with K2 and K4 in csrc/replay_bwd.cu) through
their plain twins (the card runs the kernels themselves: `chip_smoke.py`
phases 6, 8, 9 and 10, `tests/test_torch_cuda.py`, `utils/ab_render.py`).

  * K8's work order is K9's (`for_live_points`, with K8's own block and
    window): over the same sweep of point counts, warps and windows it
    runs each live point exactly once and writes each dead one once; the
    plain turbulence run batch by batch in that order (`turbulence_twin`)
    is the plain turbulence in point order bit for bit on
    two_perlin_spheres' records, and the JAX Pallas turbulence in interpret
    mode within tests/test_torch_textures.py's 1e-5.
  * K9's work order (`perlin_turb.live_claim_order`: warps claim windows of
    points from a shared counter and pack the live ones by ballot into
    batches of 32) runs each live point of a mask with two_perlin_spheres'
    live share exactly once and writes 0 for each dead one, over ragged
    windows; the plain VJP run batch by batch in that order
    (`turbulence_vjp_twin`) gives d_p bitwise the plain VJP in point order
    on two_perlin_spheres' records, and d_grad and the live d_p within
    tests/test_torch_textures.py's tolerance of the JAX Pallas VJP in
    interpret mode.
  * K7's sweep order (`replay_bwd.sweep_order`: lanes by live bounces, most
    first, stable) is a permutation; the plain replay backward over the
    permuted lanes, put back at their own indices, gives every per-lane
    output bit for bit, and its table and background cotangents match the
    JAX replay backward in interpret mode within
    tests/test_torch_deferred.py's tolerances (two_perlin_spheres).
  * The mirrored compile-time constants are the kernels'.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.ops.pallas import replay_bwd as JRB
from raytracer_weekend_tpu.ops.pallas.perlin_turb import (
    turbulence_pallas, turbulence_vjp_pallas)
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch import textures
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb as pt
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as rb

CSRC = (Path(__file__).resolve().parents[1] / "raytracer_weekend_tpu_torch"
        / "csrc")
# two_perlin_spheres' records at 400x225x16 d8: 1,128,308 live of
# 11,520,000 (chip_smoke.py phase 10).
LIVE_SHARE = 1_128_308 / 11_520_000
SIZE = dict(width=24, height=16, samples_per_pixel=2, max_depth=6, seed=3)


@pytest.fixture(scope="module")
def two_perlin():
    """two_perlin_spheres at SIZE in both packages, with the port's plain
    forward (codes and records)."""
    jc, tc = JConfig(**SIZE), TConfig(**SIZE)
    js, jst, jcams = JS.generate_scene("two_perlin_spheres", jc.aspect_ratio)
    ts, tst, tcams = TS.generate_scene("two_perlin_spheres", tc.aspect_ratio,
                                       device="cpu")
    fwd = mk.render_fused_records(ts, tc, tcams[0], 0, tc.n_rays, tc.seed,
                                  static=tst, emit_paths=True)
    return (js, jst, jc, jcams[0]), (ts, tst, tc, tcams[0]), fwd


ORDER_SWEEP = [
    (5, 3),         # fewer points than a warp
    (1037, 4),      # not a multiple of the block or window
    (20_000, 40),   # more warps than windows in a round
]


def _check_claim_order(n, warps, window):
    """live_claim_order over a random mask of two_perlin's live share runs
    each live point once, in full batches of 32 but for each warp's last,
    each batch and each warp's batches in index order, and each dead point
    once."""
    rng = np.random.default_rng(n)
    live = torch.from_numpy(rng.random(n) < LIVE_SHARE)
    live[: min(n, 3)] = True
    batches, dead = pt.live_claim_order(live, warps, window, seed=n)
    ran = torch.cat([idx for _, idx in batches]) if batches else \
        torch.zeros(0, dtype=torch.int64)
    assert torch.equal(ran.sort().values, live.nonzero().flatten())
    assert torch.equal(dead.sort().values, (~live).nonzero().flatten())
    assert all(0 < len(idx) <= 32 for _, idx in batches)
    # Only each warp's last batch may be partial.
    last = {w: k for k, (w, _) in enumerate(batches)}
    assert all(len(idx) == 32 for k, (w, idx) in enumerate(batches)
               if k != last[w])
    # A batch's points are in index order, and so are a warp's batches.
    for w in set(last):
        mine = torch.cat([idx for v, idx in batches if v == w])
        assert torch.equal(mine, mine.sort().values)


@pytest.mark.parametrize("n, warps, window",
                         [(n, w, pt.VJP_WINDOW) for n, w in ORDER_SWEEP]
                         + [(4096 + 17, 6, 64)])  # a smaller window
def test_k9_work_order_runs_each_point_once(n, warps, window):
    _check_claim_order(n, warps, window)


@pytest.mark.parametrize("n, warps, window",
                         [(n, w, pt.TURB_WINDOW) for n, w in ORDER_SWEEP]
                         + [(4096 + 17, 6, 32), (777, 2, 256)])
def test_k8_work_order_runs_each_point_once(n, warps, window):
    _check_claim_order(n, warps, window)


def _noise_records(fwd, ts):
    """two_perlin's record points and their live mask (noise texels)."""
    _, _, _, _, abc, dcode = fwd
    tid = (dcode.abs() - 1).clamp_min(0).long()
    live = ((dcode != 0) & (ts.textures.ttype[tid] == textures.NOISE))
    return abc.reshape(-1, 3), live.reshape(-1)


def test_k8_twin_matches_plain_and_jax(two_perlin):
    _, (ts, _, _, _), fwd = two_perlin
    p, live = _noise_records(fwd, ts)
    assert 0.02 < float(live.float().mean()) < 0.9
    grad, perm = ts.textures.perlin_grad, ts.textures.perlin_perm
    got = pt.turbulence_twin(grad, perm, p, 7, live, warps=5, seed=2)
    want = pt.turbulence_reference(grad, perm, p, 7, live)
    assert torch.equal(got, want)
    assert bool((got[~live] == 0).all()) and float(got[live].std()) > 0.05
    # The JAX kernel leaves dead points of a live tile to its caller.
    jt = np.asarray(turbulence_pallas(
        jnp.asarray(grad.numpy()), jnp.asarray(perm.numpy()),
        jnp.asarray(p.numpy()), 7, interpret=True,
        live=jnp.asarray(live.numpy())))
    lv = live.numpy()
    np.testing.assert_allclose(got.numpy()[lv], jt[lv], atol=1e-5, rtol=0)


def test_k9_twin_matches_plain_and_jax(two_perlin):
    _, (ts, _, _, _), fwd = two_perlin
    _, _, _, _, abc, dcode = fwd
    tid = (dcode.abs() - 1).clamp_min(0).long()
    live = ((dcode != 0) & (ts.textures.ttype[tid] == textures.NOISE))
    p, live = abc.reshape(-1, 3), live.reshape(-1)
    n = p.shape[0]
    assert 0.02 < float(live.float().mean()) < 0.9
    grad, perm = ts.textures.perlin_grad, ts.textures.perlin_perm
    ct = torch.from_numpy(np.random.default_rng(9).normal(size=n)
                          .astype(np.float32))
    dg, dp = pt.turbulence_vjp_twin(grad, perm, p, ct, 7, live, warps=5,
                                    seed=1)
    rg, rp = pt.turbulence_vjp_reference(grad, perm, p, ct, 7, live)
    assert torch.equal(dp, rp)
    assert bool((dp[~live] == 0).all())
    np.testing.assert_allclose(dg.numpy(), rg.numpy(), atol=1e-5, rtol=0)
    # The JAX kernel needs dead cotangents zeroed by its caller.
    jdg, jdp = turbulence_vjp_pallas(
        jnp.asarray(grad.numpy()), jnp.asarray(perm.numpy()),
        jnp.asarray(p.numpy()), jnp.asarray((ct * live).numpy()), 7,
        interpret=True, live=jnp.asarray(live.numpy()))
    lv = live.numpy()
    np.testing.assert_allclose(dp.numpy()[lv], np.asarray(jdp)[lv], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), atol=1e-5,
                               rtol=0)
    assert np.abs(dg.numpy()).max() > 0.1


def test_k7_sweep_order_matches_plain_and_jax(two_perlin):
    (js, jst, jc, jcam), (ts, tst, tc, tcam), fwd = two_perlin
    _, _, codes, _, abc, dcode = fwd
    n, D = codes.shape
    order = rb.sweep_order(codes, tst.n_spheres, 0)
    assert torch.equal(order.sort().values, torch.arange(n))
    # Live bounces: the leading codes that name a sphere of the table.
    hits = torch.tensor([next((k for k, c in enumerate(row)
                               if not (c > 0 and c % 4 == 1
                                       and c // 4 < tst.n_spheres)), D)
                         for row in codes.tolist()])
    h = hits[order]
    assert bool((h[:-1] >= h[1:]).all()) and len(set(hits.tolist())) > 2
    tie = h[:-1] == h[1:]
    assert bool((order[:-1][tie] < order[1:][tie]).all())    # stable
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.normal(size=(n, D, 3)).astype(np.float32))
    tid = (dcode.abs() - 1).clamp_min(0).long()
    noise = (dcode != 0) & (ts.textures.ttype[tid] == textures.NOISE)
    cabc = torch.from_numpy(rng.normal(size=(n, D, 3)).astype(np.float32)) \
        * noise[..., None]
    o, d, t, rid = TI._pixel_rays(tcam, tc, torch.arange(n), tc.seed)
    ktab = rb.pack_ktab(ts)

    def replay(perm):
        return rb.replay_bwd_fused(ktab, None, ts.background, tc, o[perm],
                                   d[perm], t[perm], rid[perm], tc.seed,
                                   codes[perm], g[perm], n, cabc=cabc[perm])

    inorder = replay(torch.arange(n))
    swept = replay(order)
    assert rb.LAUNCHES == 0          # the CPU runs the plain version
    for k in (2, 3, 4):              # d_o, d_d, d_time: per lane
        back = torch.empty_like(swept[k])
        back[order] = swept[k]
        assert torch.equal(back, inorder[k])
    assert float(inorder[2].abs().max()) > 0   # noise records reach the rays

    jo, jd, jt, jrid = JI._pixel_rays(jcam, jc, jnp.arange(n, dtype=jnp.int32),
                                      jnp.uint32(jc.seed))
    jout = JRB.replay_bwd_fused(
        JRB.pack_ktab(js), None, js.background, jc, jo, jd, jt, jrid,
        jnp.uint32(jc.seed), jnp.asarray(codes.numpy(), jnp.float32),
        jnp.asarray(g.numpy()), n, interpret=True,
        cabc=jnp.asarray(cabc.numpy()))
    # tests/test_torch_deferred.py's noise budgets: norm_rel 5e-3, cos 0.999.
    for a, b in ((swept[0], np.asarray(jout[0])[:rb.KT]),
                 (swept[5], np.asarray(jout[5]))):
        a = a.numpy()
        nb = np.linalg.norm(b)
        assert nb > 0 and np.isfinite(a).all()
        assert np.linalg.norm(a - b) / nb <= 5e-3
        assert float((a * b).sum()) / (nb * np.linalg.norm(a)) >= 0.999


@pytest.mark.parametrize("src, names, module", [
    ("perlin_turb.cu", {"kVjpBlock": "VJP_BLOCK", "kVjpWindow": "VJP_WINDOW",
                        "kTurbBlock": "TURB_BLOCK",
                        "kTurbWindow": "TURB_WINDOW"}, pt),
    ("replay_bwd.cu", {"kBins": "ORDER_BINS"}, rb),
])
def test_mirrored_constants_are_the_kernels(src, names, module):
    text = (CSRC / src).read_text()
    for cname, pname in names.items():
        m = re.search(rf"constexpr int {cname} = (\d+);", text)
        assert m, cname
        assert int(m.group(1)) == getattr(module, pname), cname
    if src == "perlin_turb.cu":   # a window is whole chunks of 32 points
        for c in (pt.VJP_WINDOW, pt.VJP_BLOCK, pt.TURB_WINDOW,
                  pt.TURB_BLOCK):
            assert c % 32 == 0
