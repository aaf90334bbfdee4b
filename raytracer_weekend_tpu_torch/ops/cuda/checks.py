"""Checks of the CUDA kernels against their plain versions on a card, shared
by `chip_smoke.py` (phase 14) and `tests/test_torch_cuda.py`.

  * `random_hit_case` and `hit_budgets`: the closest-hit kernels K10-K12
    on random tables, and the budgets that hold them to the plain brute
    force;
  * `edge_lanes`: the lanes of a replay whose radiance the float64 plain
    replay moves under a one-ulp move of the rays, where the replay
    backward (K2) and its plain version may each pick their own checker
    cell;
  * `candidate_cases`: adversarial and random float32 inputs of the
    forward kernel's division-free planar prefilter (`plane_candidate`),
    and `exact_accepts`, the test it must contain;
  * `tri_candidate_cases` and `tri_exact_accepts`: the same for K12's
    prefilter (`tri_candidate` in csrc/intersect.cu).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_weekend_tpu_torch import replay
from raytracer_weekend_tpu_torch.scene import data

# K10-K12 against their plain versions: idx equal but on near-ties, where
# |t_k - t_p| <= HIT_RTOL * max(1, |t_p|), at most n // TIE_LANES of them;
# beyond that tolerance where both hit, or hit against miss, at most
# n // OFF_LANES lanes (the expanded quadratic of a large sphere cancels).
HIT_RTOL, TIE_LANES, OFF_LANES = 1e-5, 1000, 10000
# A lane's replayed radiance "moves" when a channel changes by more than
# EDGE_REL of the lane's largest channel; edge_lanes moves the rays
# EDGE_DRAWS times.
EDGE_REL, EDGE_DRAWS = 1e-4, 4


def random_hit_case(kind: str, device, n: int, rows: int | None = None):
    """(table, (o, d, time)) on `device`: n random rays aimed into a random
    table of `kind` (spheres: a moving one every 50, a hollow one every 40;
    rects of all three axes; triangles) of `rows` rows (by default 500
    spheres, 300 rects, 3,000 triangles), 5% of the rows invalid, the
    first 6 rays axis-parallel (rays parallel to the planes of two rect
    axes)."""
    g = np.random.default_rng(14)
    if kind == "spheres":
        P = rows or 500
        c0 = g.normal(size=(P, 3)) * 4
        c1 = c0.copy()
        c1[::50] += (0.5, 0.2, 0.0)
        r = g.uniform(0.2, 1.0, P)
        r[1::40] *= -1.0
        cols = [c0, c1, np.zeros(P), np.ones(P), r, np.zeros(P, np.int32)]
        centers = c0
    elif kind == "rects":
        P = rows or 300
        lo = g.uniform(-5, 3, (P, 2))
        hi = lo + g.uniform(0.5, 2, (P, 2))
        cols = [(np.arange(P) % 3).astype(np.int32), lo[:, 0], hi[:, 0],
                lo[:, 1], hi[:, 1], g.uniform(-5, 5, P),
                np.zeros(P, np.int32)]
        centers = g.uniform(-4, 4, (P, 3))
    else:
        P = rows or 3000
        v = g.normal(size=(P, 1, 3)) * 4 + g.normal(size=(P, 3, 3))
        nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        uv = np.zeros((P, 2))
        cols = [v[:, 0], v[:, 1], v[:, 2], nrm, nrm, nrm, uv, uv, uv,
                np.zeros(P, np.int32)]
        centers = v.mean(1)
    cols = [torch.from_numpy(c if c.dtype == np.int32
                             else c.astype(np.float32)) for c in cols]
    cols.append(torch.from_numpy(g.random(P) > 0.05))
    typ = {"spheres": data.Spheres, "rects": data.Rects,
           "triangles": data.Triangles}[kind]
    tgt = centers[g.integers(0, P, n)] + g.normal(size=(n, 3)) * 0.5
    o = tgt + g.normal(size=(n, 3)) * 10
    d = tgt - o
    d[:6] = np.concatenate([np.eye(3), -np.eye(3)])
    o[:6] = tgt[:6] - 8 * d[:6]
    return typ(*cols).to(device), tuple(
        torch.from_numpy(x.astype(np.float32)).to(device)
        for x in (o, d, g.random(n)))


def hit_budgets(t_k, i_k, t_p, i_p) -> dict:
    """A closest-hit kernel's (t, idx) against its plain version's -> stats,
    `ok` false when a budget above is exceeded or two misses disagree on
    idx (both give 0)."""
    n = t_p.shape[0]
    fk, fp = torch.isfinite(t_k), torch.isfinite(t_p)
    both = fk & fp
    diff = (t_k - t_p).abs()
    close = both & (diff <= HIT_RTOL * t_p.abs().clamp_min(1.0))
    other = i_k.long() != i_p.long()
    far = both & ~close
    stats = dict(rays=n, hits=int(both.sum()),
                 near_ties=int((close & other).sum()),
                 tie_budget=max(4, n // TIE_LANES),
                 t_beyond_tol=int(far.sum()),
                 hit_vs_miss=int((fk != fp).sum()),
                 off_budget=max(4, n // OFF_LANES),
                 idx_differs_on_misses=int((other & ~fk & ~fp).sum()),
                 max_abs_err=float(diff[both].max()) if bool(both.any())
                 else 0.0)
    if far.any():
        j = int(torch.nonzero(far)[0, 0])
        stats["first_beyond"] = dict(lane=j, t_kernel=float(t_k[j]),
                                     t_plain=float(t_p[j]),
                                     idx_kernel=int(i_k[j]),
                                     idx_plain=int(i_p[j]))
    stats["ok"] = (stats["near_ties"] <= stats["tie_budget"]
                   and stats["t_beyond_tol"] + stats["hit_vs_miss"]
                   <= stats["off_budget"]
                   and not stats["idx_differs_on_misses"])
    return stats


def _replay(scene, static, cfg, o, d, t, rid, codes, windows, dtype):
    """`replay.replay_rays` in lane windows with every float in `dtype`."""
    leaves = [le.to(dtype) if le.is_floating_point() else le
              for le in scene.leaves()]
    scene = data.SceneData.from_leaves(leaves, scene.trees)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.no_grad():
            return torch.cat([replay.replay_rays(
                scene, static, cfg, o[w].to(dtype), d[w].to(dtype),
                t[w].to(dtype), rid[w], cfg.seed, codes[w]) for w in windows])
    finally:
        torch.set_default_dtype(prev)


def edge_lanes(scene, static, cfg, o, d, t, rid, codes, windows):
    """(n,) bool: the lanes whose radiance along `codes`, replayed by the
    plain replay in float64, moves when the rays o and d move by one
    float32 ulp (each component up or down at random; EDGE_DRAWS times), or
    which the float32 plain replay gives apart from it. A hit point within
    rounding of a checker cell edge: each float32 version picks its side
    for itself, and a lane whose cell flips sends its cotangent to the
    other color."""
    ref = _replay(scene, static, cfg, o, d, t, rid, codes, windows,
                  torch.float64)

    def moved(rad):
        top = ref.abs().amax(dim=1, keepdim=True)
        return ((rad.double() - ref).abs() > EDGE_REL * top).any(dim=1)

    out = moved(_replay(scene, static, cfg, o, d, t, rid, codes, windows,
                        torch.float32))
    gen = torch.Generator(device=o.device).manual_seed(13)
    for _ in range(EDGE_DRAWS):
        jit = [x.double() * (1.0 + 2.0 ** -23 * (2 * torch.randint(
            0, 2, x.shape, device=x.device, generator=gen) - 1))
            for x in (o, d)]
        out |= moved(_replay(scene, static, cfg, *jit, t, rid, codes,
                             windows, torch.float64))
    return out


# The planar prefilter's cases: these t_min values, each with its own
# adversarial set.
CAND_T_MINS = (1e-3, 0.5, 7.0)


def _ulps(x, k):
    """x and its neighbours k float32 ulps away on each side."""
    out = [x]
    lo = hi = np.float32(x)
    with np.errstate(over="ignore"):
        for _ in range(k):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            out += [lo, hi]
    return out


def candidate_cases(t_min: float, n_random: int = 0, seed: int = 0):
    """(num, den, best) float32 numpy arrays at `t_min`: every den of an
    adversarial list (+-0, subnormals, FLT_MIN, FLT_MAX, +-inf, NaN, and
    ordinary magnitudes) against bests (+inf, t_min and its neighbours,
    ordinary and huge ones) and quotients at t_min and best, one and two
    ulps on either side of each, zero, negative, tiny, huge, inf and NaN,
    the numerator also moved one ulp either way and replaced by +-0, +-inf,
    NaN and subnormals; then `n_random` cases with log-uniform magnitudes
    and random signs."""
    f32 = np.float32
    tm = f32(t_min)
    mags = [0.0, 1e-45, 1e-40, 1.1754944e-38, 1e-30, 1e-20, 1e-3, 0.7, 1.0,
            3.0, 1e3, 1e20, 1e30, 3.4028235e38, np.inf]
    dens = [f32(s * m) for m in mags for s in (1.0, -1.0)] + [f32(np.nan)]
    bests = (_ulps(tm, 2) + [f32(2.0) * tm, f32(1.0), f32(1e3), f32(1e30),
                             f32(3.4028235e38), f32(np.inf)])
    nums, ds, bs = [], [], []
    for best in bests:
        ts = _ulps(tm, 2) + [f32(0.0), -tm, f32(1e-40), f32(1e30), f32(np.inf),
                             f32(np.nan), f32(0.5) * tm]
        if np.isfinite(best):
            ts += _ulps(best, 2)
        for den in dens:
            for t in ts:
                with np.errstate(all="ignore"):
                    num = f32(np.float64(t) * np.float64(den))
                for nv in _ulps(num, 1):
                    nums.append(nv)
                    ds.append(den)
                    bs.append(best)
            for nv in (0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40,
                       1.0, -1.0):
                nums.append(f32(nv))
                ds.append(den)
                bs.append(best)
    num, den, best = (np.array(x, dtype=f32) for x in (nums, ds, bs))
    if n_random:
        g = np.random.default_rng(seed)

        def logu(n):
            return (g.choice([-1.0, 1.0], n)
                    * 10.0 ** g.uniform(-44.0, 38.0, n)).astype(f32)

        rb = np.abs(logu(n_random))
        rb = np.where(rb < tm, np.inf, rb).astype(f32)
        num = np.concatenate([num, logu(n_random)])
        den = np.concatenate([den, logu(n_random)])
        best = np.concatenate([best, rb])
    return num, den, best


def exact_accepts(num, den, best, t_min):
    """The planar test the prefilter must contain: t = num / den (IEEE
    float32), t >= t_min && t < best -> bool, on tensors of any device."""
    t = num / den
    return (t >= torch.tensor(t_min, dtype=torch.float32, device=t.device)) \
        & (t < best)


def tri_candidate_cases(t_min: float, n_random: int = 0, seed: int = 0):
    """(det, u_num, v_num, t_num, best) float32 numpy arrays at `t_min`:
    every det of an adversarial list (+-0, subnormals, FLT_MIN, FLT_MAX,
    +-inf, NaN, ordinary magnitudes) against bests (+inf, t_min and its
    neighbours, ordinary and huge ones), with t at t_min and at best, one
    ulp on either side of each, 0, negative, tiny, huge, inf and NaN, and
    (u, v) on the edges of the triangle (0, u + v = 1) and just outside, as
    numerators RN(x det); each case also with one numerator moved one ulp
    either way, and with u_num or v_num replaced by +-0, +-1e-45 (which
    underflows to -0 against |det| >= 2), +-inf and NaN. Then `n_random`
    cases: half with log-uniform magnitudes and random signs, half as
    RN(x det) of a log-uniform det and t and (u, v) uniform on [-0.2, 1.2];
    best +inf, or t scaled by 1 +- a few ulps, or log-uniform."""
    f32 = np.float32
    tm = f32(t_min)
    mags = [0.0, 1e-45, 1e-40, 1.1754944e-38, 1e-30, 1e-20, 1e-3, 0.7, 1.0,
            3.0, 1e3, 1e20, 1e30, 3.4028235e38, np.inf]
    dets = [f32(s * m) for m in mags for s in (1.0, -1.0)] + [f32(np.nan)]
    bests = _ulps(tm, 1) + [f32(2.0) * tm, f32(1.0), f32(1e30), f32(np.inf)]
    uvs = [(0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (0.25, 0.75), (0.5, 0.5),
           (0.3, 0.7), (1.0 / 3.0, 2.0 / 3.0), (0.2, 0.3), (-0.1, 0.5),
           (0.5, -1e-3), (0.6, 0.6), (1e-40, 0.9)]
    specials = [0.0, -0.0, 1e-45, -1e-45, np.inf, -np.inf, np.nan]
    rows = []

    def rn(x, den):
        with np.errstate(all="ignore"):
            return f32(np.float64(x) * np.float64(den))

    for det in dets:
        for best in bests:
            ts = _ulps(tm, 1) + [f32(0.0), -tm, f32(1e-40), f32(1e30),
                                 f32(np.inf), f32(np.nan), f32(0.5) * tm]
            if np.isfinite(best):
                ts += _ulps(best, 1)
            for t in ts:
                tn = rn(t, det)
                for u, v in uvs:
                    un, vn = rn(u, det), rn(v, det)
                    rows.append((det, un, vn, tn, best))
                    for k in (1, 2, 3):
                        base = [un, vn, tn]
                        for x in _ulps(base[k - 1], 1)[1:]:
                            moved = list(base)
                            moved[k - 1] = x
                            rows.append((det, *moved, best))
                for x in specials:
                    rows.append((det, f32(x), rn(0.5, det), tn, best))
                    rows.append((det, rn(0.5, det), f32(x), tn, best))
    det, un, vn, tn, best = (np.array(x, dtype=f32) for x in zip(*rows))
    if n_random:
        g = np.random.default_rng(seed)
        h = n_random // 2

        def logu(n, lo=-44.0, hi=38.0):
            return (g.choice([-1.0, 1.0], n)
                    * 10.0 ** g.uniform(lo, hi, n)).astype(f32)

        r_det = np.concatenate([logu(h), logu(n_random - h, -30.0, 30.0)])
        t = np.concatenate([logu(h), np.abs(logu(n_random - h, -4.0, 4.0))])
        u = g.uniform(-0.2, 1.2, n_random - h)
        v = g.uniform(-0.2, 1.2, n_random - h)
        with np.errstate(all="ignore"):
            r_tn = np.concatenate([t[:h], (t[h:].astype(np.float64)
                                           * r_det[h:]).astype(f32)])
            r_un = np.concatenate([logu(h), (u * r_det[h:]).astype(f32)])
            r_vn = np.concatenate([logu(h), (v * r_det[h:]).astype(f32)])
            pick = g.integers(0, 3, n_random)
            near = (np.abs(t).astype(np.float64)
                    * (1.0 + g.integers(-3, 4, n_random) * 2.0**-23))
            r_best = np.where(pick == 0, np.inf,
                              np.where(pick == 1, near,
                                       np.abs(logu(n_random))))
        r_best = np.where(r_best < tm, np.inf, r_best).astype(f32)
        det, un, vn, tn, best = (np.concatenate([a, b]) for a, b in
                                 ((det, r_det), (un, r_un), (vn, r_vn),
                                  (tn, r_tn), (best, r_best)))
    return det, un, vn, tn, best


def tri_exact_accepts(det, u_num, v_num, t_num, t_min, best):
    """K12's exact test, the bits of the kernel and of the plain version
    (float32 tensors of any device): det != 0, and with inv = RN(1 / det),
    u = u_num inv >= 0, v = v_num inv >= 0, RN(u + v) <= 1,
    t = t_num inv >= t_min, t >= 0 and t < best -> bool."""
    degenerate = det == 0.0
    inv = 1.0 / torch.where(degenerate, 1.0, det)
    u, v, t = u_num * inv, v_num * inv, t_num * inv
    tm = torch.tensor(t_min, dtype=torch.float32, device=t.device)
    return ((t >= tm) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0)
            & (u + v <= 1.0) & ~degenerate & (t < best))
