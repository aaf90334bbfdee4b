"""The plain reference path tracer: plain torch, no kernel, no cache.

It renders a `scenes.SceneDesc` with the semantics of the program's staged
path (Ray Tracing in One Weekend / The Next Week, re-associated into an
iterative loop over bounces): the counter-based PCG4D random numbers keyed on
(seed, lane, depth, salt), the thin-lens camera with a shutter, moving
spheres, axis-aligned rects, sphere-bounded constant media with the
reference's log10 distance quirk, triangles with per-vertex normals and
uvs, Lambertian / metal / dielectric / light /
isotropic materials over solid, checker, Perlin-marble and image textures.
Each family's closest hit is a brute force over every row; the families
merge spheres, rects, triangles, media in that order with a strict `<`.

It imports nothing of the program and takes nothing the program made: the
tables are worked out here from the scene's numbers. Given the same scene,
seed and lanes it traces the same paths as the program, so the two agree to
float rounding, apart from the few lanes where a rounding flips a decision
(a hit, a reflect-or-refract draw).

`dtype` runs the whole trace in another float type (the control: bfloat16
in place of float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference.scenes import SceneDesc

# -- counter-based random numbers (PCG4D, Jarzynski & Olano 2020) ----------

SALT_PIXEL_JITTER = 0x9E3779B1
SALT_LENS = 0x85EBCA77
SALT_TIME = 0xC2B2AE3D
SALT_LAMBERTIAN = 0x27D4EB2F
SALT_METAL = 0x165667B1
SALT_DIELECTRIC = 0xD3A2646C
SALT_ISOTROPIC = 0xFD7046C5
SALT_VOLUME = 0xB55A4F09
_M32 = 0xFFFFFFFF
LN10_INV = 0.43429448190325176


def _u32(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=like.device)


def _mul32(a, b):
    """(a * b) mod 2^32 in int64 without overflow (16-bit halves)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def pcg4d(x, y, z, w):
    like = next(t for t in (x, y, z, w) if isinstance(t, torch.Tensor))
    v = [(_u32(t, like) * 1664525 + 1013904223) & _M32 for t in (x, y, z, w)]
    for shift in (False, True):
        if shift:
            v = [t ^ (t >> 16) for t in v]
        v[0] = (v[0] + _mul32(v[1], v[3])) & _M32
        v[1] = (v[1] + _mul32(v[2], v[0])) & _M32
        v[2] = (v[2] + _mul32(v[0], v[1])) & _M32
        v[3] = (v[3] + _mul32(v[1], v[2])) & _M32
    return v


def rand4(seed, ray_id, depth, salt, dtype=torch.float32):
    """Four uniforms in [0, 1) per lane (top 24 bits), (..., 4)."""
    bits = pcg4d(ray_id, depth, salt, seed)
    u = torch.stack([(b >> 8).to(torch.float32) * (1.0 / (1 << 24))
                     for b in bits], dim=-1)
    return u.to(dtype)


def _unit_vector(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _in_unit_sphere(u1, u2, u3):
    return _unit_vector(u1, u2) * torch.pow(u3, 1.0 / 3.0)[..., None]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(a, eps=0.0):
    return a / torch.sqrt(_dot(a, a) + eps)[..., None]


def _reflect(v, n):
    return v - 2.0 * _dot(v, n)[..., None] * n


def _refract(uv, n, eta):
    cos_theta = torch.clamp_max(_dot(-uv, n), 1.0)
    perp = eta[..., None] * (uv + cos_theta[..., None] * n)
    par = -torch.sqrt(torch.clamp_min(
        torch.abs(1.0 - _dot(perp, perp)), 1e-12))[..., None] * n
    return perp + par


# -- tables -----------------------------------------------------------------

_MAT = {"lambertian": 0, "metal": 1, "dielectric": 2, "light": 3,
        "isotropic": 4}
_TEX = {"solid": 0, "checker": 1, "noise": 2, "image": 3}


def perlin_tables(seed: int):
    """256 unit gradients and three permutations of 0..255 from `seed`."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, 1.0, size=(256, 3)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    perms = np.stack([rng.permutation(256) for _ in range(3)]).astype(
        np.int64)
    return g, perms


class Tables(NamedTuple):
    """The reference's own tables of a scene."""

    c0: torch.Tensor
    c1: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    radius: torch.Tensor
    smat: torch.Tensor
    raxis: torch.Tensor
    ra0: torch.Tensor
    ra1: torch.Tensor
    rb0: torch.Tensor
    rb1: torch.Tensor
    rk: torch.Tensor
    rmat: torch.Tensor
    tv0: torch.Tensor
    tv1: torch.Tensor
    tv2: torch.Tensor
    tn0: torch.Tensor
    tn1: torch.Tensor
    tn2: torch.Tensor
    tuv0: torch.Tensor
    tuv1: torch.Tensor
    tuv2: torch.Tensor
    tmat: torch.Tensor
    vcenter: torch.Tensor
    vradius: torch.Tensor
    vneg_inv_density: torch.Tensor
    vmat: torch.Tensor
    mtype: torch.Tensor
    mtex: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    ttype: torch.Tensor
    color1: torch.Tensor
    color2: torch.Tensor
    scale: torch.Tensor
    image_id: torch.Tensor
    perlin_grad: torch.Tensor
    perlin_perm: torch.Tensor
    images: torch.Tensor
    image_hw: torch.Tensor
    background: torch.Tensor

    @classmethod
    def build(cls, s: SceneDesc, device, dtype=torch.float32) -> "Tables":
        def f(x, shape=None):
            a = np.asarray(x, np.float64)
            if shape is not None:
                a = a.reshape(shape)
            # float32 first: the scene's numbers as float32 states them.
            return torch.tensor(a.astype(np.float32), device=device).to(dtype)

        def i(x):
            return torch.tensor(np.asarray(x, np.int64), device=device)

        sp, rc, vo, tr = s.spheres, s.rects, s.volumes, s.triangles

        def tri(part, k, width):
            return f([t[part][k] for t in tr], (-1, width))

        names = sorted(s.images)
        if names:
            h = max(s.images[n].shape[0] for n in names)
            w = max(s.images[n].shape[1] for n in names)
            atlas = np.zeros((len(names), h, w, 3), np.float32)
            hw = np.zeros((len(names), 2), np.int64)
            for k, n in enumerate(names):
                im = s.images[n]
                atlas[k, :im.shape[0], :im.shape[1]] = im
                hw[k] = im.shape[:2]
        else:
            atlas, hw = np.zeros((1, 1, 1, 3), np.float32), np.ones((1, 2))
        tex = s.textures
        grad, perm = perlin_tables(s.perlin_seed)
        return cls(
            c0=f([r[0] for r in sp], (-1, 3)), c1=f([r[1] for r in sp],
                                                    (-1, 3)),
            t0=f([r[2] for r in sp]), t1=f([r[3] for r in sp]),
            radius=f([r[4] for r in sp]), smat=i([r[5] for r in sp]),
            raxis=i([r[0] for r in rc]), ra0=f([r[1] for r in rc]),
            ra1=f([r[2] for r in rc]), rb0=f([r[3] for r in rc]),
            rb1=f([r[4] for r in rc]), rk=f([r[5] for r in rc]),
            rmat=i([r[6] for r in rc]),
            tv0=tri(0, 0, 3), tv1=tri(0, 1, 3), tv2=tri(0, 2, 3),
            tn0=tri(1, 0, 3), tn1=tri(1, 1, 3), tn2=tri(1, 2, 3),
            tuv0=tri(2, 0, 2), tuv1=tri(2, 1, 2), tuv2=tri(2, 2, 2),
            tmat=i([t[3] for t in tr]),
            vcenter=f([v[0] for v in vo], (-1, 3)),
            vradius=f([v[1] for v in vo]),
            vneg_inv_density=f([-1.0 / v[2] for v in vo]),
            vmat=i([v[3] for v in vo]),
            mtype=i([_MAT[m["type"]] for m in s.materials]),
            mtex=i([m["tex"] for m in s.materials]),
            fuzz=f([m["fuzz"] for m in s.materials]),
            ior=f([m["ior"] for m in s.materials]),
            ttype=i([_TEX[t["type"]] for t in tex]),
            color1=f([t["color1"] for t in tex], (-1, 3)),
            color2=f([t["color2"] for t in tex], (-1, 3)),
            scale=f([t["scale"] for t in tex]),
            image_id=i([names.index(t["image"]) if t["image"] else 0
                        for t in tex]),
            perlin_grad=f(grad), perlin_perm=i(perm),
            images=f(atlas), image_hw=i(hw), background=f(s.background))


# -- camera -----------------------------------------------------------------

def camera_frame(cam: dict, device, dtype):
    """The look-at frame, computed in float32 as the program states it."""
    f32 = torch.float32
    look_from = torch.tensor(cam["look_from"], dtype=f32)
    look_at = torch.tensor(cam["look_at"], dtype=f32)
    up = torch.tensor(cam["up"], dtype=f32)
    h = torch.tan(torch.tensor(cam["vfov"], dtype=f32) * (math.pi / 180.0)
                  / 2.0)
    vh = 2.0 * h
    vw = cam["aspect"] * vh
    w = _normalize(look_from - look_at)
    u = _normalize(torch.linalg.cross(up, w))
    v = torch.linalg.cross(w, u)
    horizontal = cam["focus"] * vw * u
    vertical = cam["focus"] * vh * v
    lower_left = look_from - horizontal / 2.0 - vertical / 2.0 \
        - cam["focus"] * w
    out = dict(origin=look_from, lower_left=lower_left, horizontal=horizontal,
               vertical=vertical, u=u, v=v,
               lens_radius=torch.tensor(cam["aperture"] / 2.0, dtype=f32),
               time0=torch.tensor(cam["t0"], dtype=f32),
               time1=torch.tensor(cam["t1"], dtype=f32))
    return {k: t.to(device=device, dtype=dtype) for k, t in out.items()}


def primary_rays(cam, width, height, spp, lanes, seed, dtype):
    """Rays of lanes (pixel * spp + sample), row 0 at the image bottom."""
    pix = torch.div(lanes, spp, rounding_mode="floor")
    col = (pix % width).to(dtype)
    row = (height - 1 - torch.div(pix, width, rounding_mode="floor")).to(dtype)
    ray_id = lanes & _M32
    uj = rand4(seed, ray_id, 0, SALT_PIXEL_JITTER, dtype)
    s = (col + uj[..., 0]) / float(width - 1)
    t = (row + uj[..., 1]) / float(height - 1)
    ul = rand4(seed, ray_id, 0, SALT_LENS, dtype)
    r = torch.sqrt(ul[..., 0])
    phi = 2.0 * math.pi * ul[..., 1]
    rd = cam["lens_radius"] * torch.stack([r * torch.cos(phi),
                                           r * torch.sin(phi)], dim=-1)
    offset = cam["u"] * rd[..., 0:1] + cam["v"] * rd[..., 1:2]
    ut = rand4(seed, ray_id, 0, SALT_TIME, dtype)[..., 0]
    time = cam["time0"] + ut * (cam["time1"] - cam["time0"])
    o = cam["origin"] + offset
    d = (cam["lower_left"] + s[..., None] * cam["horizontal"]
         + t[..., None] * cam["vertical"] - cam["origin"] - offset)
    return o, d, time, ray_id


# -- closest hits (brute force) --------------------------------------------

def _hit_spheres(T: Tables, o, d, time, t_min):
    """(t, row) per ray; +inf on a miss. The pairwise
    dots are (B,3)x(3,S) products of the expanded quadratic."""
    dc = T.c1 - T.c0
    w = (time[:, None] - T.t0[None, :]) / (T.t1 - T.t0)[None, :]
    a = _dot(d, d)[:, None]
    o_d = _dot(o, d)[:, None]
    o_sq = _dot(o, o)[:, None]
    d_c = d @ T.c0.T + w * (d @ dc.T)
    o_c = o @ T.c0.T + w * (o @ dc.T)
    c_sq = (_dot(T.c0, T.c0)[None, :] + 2.0 * w * _dot(T.c0, dc)[None, :]
            + w * w * _dot(dc, dc)[None, :])
    half_b = o_d - d_c
    c_term = o_sq - 2.0 * o_c + c_sq - (T.radius * T.radius)[None, :]
    disc = half_b * half_b - a * c_term
    ok = disc > 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    r1 = (-half_b - sq) / a
    r2 = (-half_b + sq) / a
    root = torch.where(r1 >= t_min, r1, r2)
    t_all = torch.where(ok & (root >= t_min), root, math.inf)
    return torch.amin(t_all, dim=-1), torch.argmin(t_all, dim=-1)


def _rect_axes(axis):
    return axis, torch.where(axis == 0, 1, 0), torch.where(axis == 2, 1, 2)


def _hit_rects(T: Tables, o, d, t_min):
    f, a, b = _rect_axes(T.raxis)
    t = (T.rk[None, :] - o[:, f]) / d[:, f]
    av = o[:, a] + t * d[:, a]
    bv = o[:, b] + t * d[:, b]
    hit = ((t >= t_min) & (av >= T.ra0) & (av <= T.ra1) & (bv >= T.rb0)
           & (bv <= T.rb1))
    t_all = torch.where(hit, t, math.inf)
    return torch.amin(t_all, dim=-1), torch.argmin(t_all, dim=-1)


def _hit_triangles(T: Tables, o, d, t_min):
    """Möller-Trumbore per ray and triangle in the scalar-triple form, its
    pairwise terms (B,3)x(3,T) products."""
    ab, ac = T.tv1 - T.tv0, T.tv2 - T.tv0
    n = torch.linalg.cross(ab, ac)
    w = torch.linalg.cross(o, d)
    det = -(d @ n.T)
    u_num = (w @ ac.T) - (d @ torch.linalg.cross(ac, T.tv0).T)
    v_num = -((w @ ab.T) - (d @ torch.linalg.cross(ab, T.tv0).T))
    t_num = (o @ n.T) - _dot(T.tv0, n)[None, :]
    flat = det == 0.0
    inv = 1.0 / torch.where(flat, 1.0, det)
    u, v, t = u_num * inv, v_num * inv, t_num * inv
    hit = ((t >= t_min) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & ~flat)
    t_all = torch.where(hit, t, math.inf)
    return torch.amin(t_all, dim=-1), torch.argmin(t_all, dim=-1)


def _volume_candidates(T: Tables, o, d, t_min, seed, ray_id, depth, log10):
    """Scatter distance per (ray, medium), +inf where it does not scatter."""
    oc = o[:, None, :] - T.vcenter[None, :, :]
    dd = d[:, None, :]
    a = _dot(dd, dd)
    half_b = _dot(oc, dd)
    c_term = _dot(oc, oc) - (T.vradius ** 2)[None, :]
    disc = half_b * half_b - a * c_term
    ok = disc > 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    enter = (-half_b - sq) / a
    exit_ = (-half_b + sq) / a
    t1c = torch.clamp_min(enter, t_min)
    ok = ok & (t1c < exit_)
    t1c = torch.clamp_min(t1c, 0.0)
    ray_len = torch.sqrt(_dot(d, d))[:, None]
    inside = (exit_ - t1c) * ray_len
    n = T.vradius.shape[0]
    salts = SALT_VOLUME + torch.arange(n, dtype=torch.int64, device=o.device)
    u = rand4(seed, ray_id[:, None], depth, salts[None, :], o.dtype)[..., 0]
    log_u = torch.log(torch.clamp(u, 1e-12, 1.0)) * (LN10_INV if log10
                                                      else 1.0)
    dist = T.vneg_inv_density[None, :] * log_u
    return torch.where(ok & (dist <= inside), t1c + dist / ray_len, math.inf)


# -- textures and materials ---------------------------------------------------

def _noise(T: Tables, p):
    pf = torch.floor(p)
    base = pf.to(torch.int64)
    frac = p - pf
    corners = torch.tensor([[i, j, k] for i in range(2) for j in range(2)
                            for k in range(2)], device=p.device)
    lat = (base[..., None, :] + corners) & 255
    perm = T.perlin_perm
    h = (perm[0][lat[..., 0]] ^ perm[1][lat[..., 1]]
         ^ perm[2][lat[..., 2]]) & 255
    grad = T.perlin_grad[h]
    u = frac * frac * (3.0 - 2.0 * frac)
    cf = corners.to(p.dtype)
    weight_v = u[..., None, :] - cf
    blend = torch.prod(cf * u[..., None, :] + (1.0 - cf)
                       * (1.0 - u[..., None, :]), dim=-1)
    return torch.sum(blend * torch.sum(grad * weight_v, dim=-1), dim=-1)


def _turbulence(T: Tables, p, depth=7):
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * _noise(T, p)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(acc)


def _texture(T: Tables, tid, u, v, p, has_noise, has_image):
    ttype = T.ttype[tid]
    c1, c2, scale = T.color1[tid], T.color2[tid], T.scale[tid]
    sp = torch.sin(scale[..., None] * p)
    sines = sp[..., 0] * sp[..., 1] * sp[..., 2]
    out = torch.where((ttype == 1)[..., None],
                      torch.where(sines[..., None] < 0.0, c2, c1), c1)
    if has_noise:
        marble = 0.5 * (1.0 + torch.sin(scale * p[..., 2]
                                        + 10.0 * _turbulence(T, p)))
        out = torch.where((ttype == 2)[..., None], marble[..., None]
                          .expand_as(out), out)
    if has_image:
        iid = T.image_id[tid]
        hw = T.image_hw[iid]
        uc = torch.clamp(u, 0.0, 1.0)
        vc = 1.0 - torch.clamp(v, 0.0, 1.0)
        col = torch.minimum(torch.clamp_min((uc * hw[:, 1].to(u.dtype))
                                            .to(torch.int64), 0), hw[:, 1] - 1)
        row = torch.minimum(torch.clamp_min((vc * hw[:, 0].to(u.dtype))
                                            .to(torch.int64), 0), hw[:, 0] - 1)
        out = torch.where((ttype == 3)[..., None], T.images[iid, row, col],
                          out)
    return out


def _sphere_uv(n):
    theta = torch.arccos(torch.clamp(-n[..., 1], -0.9999999, 0.9999999))
    phi = torch.atan2(-n[..., 2], n[..., 0]) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi


class _Scatter(NamedTuple):
    direction: torch.Tensor
    attenuation: torch.Tensor
    emitted: torch.Tensor
    alive: torch.Tensor


def _scatter(T: Tables, mat, d, p, normal, front, u, v, seed, ray_id, depth,
             has_noise, has_image):
    dt = d.dtype
    mtype, fuzz, ior = T.mtype[mat], T.fuzz[mat], T.ior[mat]
    color = _texture(T, T.mtex[mat], u, v, p, has_noise, has_image)
    unit_in = _normalize(d, eps=1e-20)
    ul = rand4(seed, ray_id, depth, SALT_LAMBERTIAN, dt)
    lam = normal + _unit_vector(ul[..., 0], ul[..., 1])
    lam = torch.where(torch.all(torch.abs(lam) < 1e-8, dim=-1)[..., None],
                      normal, lam)
    um = rand4(seed, ray_id, depth, SALT_METAL, dt)
    met = _reflect(unit_in, normal) + fuzz[..., None] * _in_unit_sphere(
        um[..., 0], um[..., 1], um[..., 2])
    met_alive = _dot(met, normal) > 0.0
    ud = rand4(seed, ray_id, depth, SALT_DIELECTRIC, dt)[..., 0]
    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(_dot(-unit_in, normal), 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
    choose_reflect = (ratio * sin_t > 1.0) | (refl > ud)
    die = torch.where(choose_reflect[..., None], _reflect(unit_in, normal),
                      _refract(unit_in, normal, ratio))
    ui = rand4(seed, ray_id, depth, SALT_ISOTROPIC, dt)
    iso = _in_unit_sphere(ui[..., 0], ui[..., 1], ui[..., 2])
    is_met, is_die = (mtype == 1)[..., None], (mtype == 2)[..., None]
    is_iso, is_light = (mtype == 4)[..., None], mtype == 3
    direction = torch.where(is_met, met, lam)
    direction = torch.where(is_die, die, direction)
    direction = torch.where(is_iso, iso, direction)
    zeros = torch.zeros_like(color)
    att = torch.where(is_die, torch.ones_like(color), color)
    att = torch.where(is_light[..., None], zeros, att)
    emitted = torch.where(is_light[..., None], color, zeros)
    alive = torch.where(mtype == 1, met_alive, ~is_light)
    return _Scatter(direction, att, emitted, alive)


# -- the bounce loop --------------------------------------------------------

def trace(T: Tables, o, d, time, ray_id, seed, max_depth: int,
          t_min: float = 1e-3, log10: bool = True):
    """Radiance (B, 3) and segments (B,) int of a batch of rays."""
    B, dev, dt = o.shape[0], o.device, o.dtype
    n_s, n_r, n_t, n_v = (T.radius.shape[0], T.rk.shape[0],
                          T.tmat.shape[0], T.vradius.shape[0])
    has_noise = bool((T.ttype == 2).any())
    has_image = bool((T.ttype == 3).any())
    throughput = torch.ones((B, 3), device=dev, dtype=dt)
    radiance = torch.zeros((B, 3), device=dev, dtype=dt)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    segments = torch.zeros((B,), dtype=torch.int64, device=dev)
    for depth in range(max_depth):
        segments = segments + alive.to(torch.int64)
        t = torch.full((B,), math.inf, device=dev, dtype=dt)
        fam = torch.full((B,), -1, dtype=torch.int64, device=dev)
        idx = torch.zeros((B,), dtype=torch.int64, device=dev)
        if n_s:
            t_s, i_s = _hit_spheres(T, o, d, time, t_min)
            better = t_s < t
            t, fam, idx = (torch.where(better, t_s, t),
                           torch.where(better, 0, fam),
                           torch.where(better, i_s, idx))
        if n_r:
            t_r, i_r = _hit_rects(T, o, d, t_min)
            better = t_r < t
            t, fam, idx = (torch.where(better, t_r, t),
                           torch.where(better, 1, fam),
                           torch.where(better, i_r, idx))
        if n_t:
            t_t, i_t = _hit_triangles(T, o, d, t_min)
            better = t_t < t
            t, fam, idx = (torch.where(better, t_t, t),
                           torch.where(better, 2, fam),
                           torch.where(better, i_t, idx))
        if n_v:
            cand = _volume_candidates(T, o, d, t_min, seed, ray_id,
                                      depth, log10)
            t_v, i_v = torch.amin(cand, dim=-1), torch.argmin(cand, -1)
            better = t_v < t
            t, fam, idx = (torch.where(better, t_v, t),
                           torch.where(better, 3, fam),
                           torch.where(better, i_v, idx))
        hit = torch.isfinite(t)
        t = torch.where(hit, t, 0.0)
        is_s, is_r, is_t, is_v = fam == 0, fam == 1, fam == 2, fam == 3
        p = torch.zeros((B, 3), device=dev, dtype=dt)
        outward = torch.zeros((B, 3), device=dev, dtype=dt)
        u = torch.zeros((B,), device=dev, dtype=dt)
        v = torch.zeros((B,), device=dev, dtype=dt)
        mat = torch.zeros((B,), dtype=torch.int64, device=dev)
        if n_s:
            i = torch.where(is_s, idx, 0)
            c0, c1 = T.c0[i], T.c1[i]
            w = (time - T.t0[i]) / (T.t1[i] - T.t0[i])
            center = c0 + w[:, None] * (c1 - c0)
            r = T.radius[i]
            ps = o + t[:, None] * d
            out_s = (ps - center) / r[:, None]
            us, vs = _sphere_uv(out_s) if has_image else (u, v)
            m = is_s[:, None]
            p = torch.where(m, ps, p)
            outward = torch.where(m, out_s, outward)
            u, v = torch.where(is_s, us, u), torch.where(is_s, vs, v)
            mat = torch.where(is_s, T.smat[i], mat)
        if n_r:
            i = torch.where(is_r, idx, 0)
            f, ax, bx = _rect_axes(T.raxis[i])
            pr = o + t[:, None] * d
            av = pr.gather(1, ax[:, None])[:, 0]
            bv = pr.gather(1, bx[:, None])[:, 0]
            ur = (av - T.ra0[i]) / (T.ra1[i] - T.ra0[i])
            vr = (bv - T.rb0[i]) / (T.rb1[i] - T.rb0[i])
            out_r = torch.nn.functional.one_hot(f, 3).to(dt)
            m = is_r[:, None]
            p = torch.where(m, pr, p)
            outward = torch.where(m, out_r, outward)
            u, v = torch.where(is_r, ur, u), torch.where(is_r, vr, v)
            mat = torch.where(is_r, T.rmat[i], mat)
        if n_t:
            i = torch.where(is_t, idx, 0)
            v0, v1, v2 = T.tv0[i], T.tv1[i], T.tv2[i]
            ab, ac = v1 - v0, v2 - v0
            det = -_dot(d, torch.linalg.cross(ab, ac))
            inv = 1.0 / torch.where(det == 0.0, 1.0, det)
            ao_x_d = torch.linalg.cross(o - v0, d)
            ut = _dot(ac, ao_x_d) * inv
            vt = -_dot(ab, ao_x_d) * inv
            w0, wu, wv = (1.0 - ut - vt)[:, None], ut[:, None], vt[:, None]
            nt = w0 * T.tn0[i] + wu * T.tn1[i] + wv * T.tn2[i]
            uvt = w0 * T.tuv0[i] + wu * T.tuv1[i] + wv * T.tuv2[i]
            m = is_t[:, None]
            p = torch.where(m, o + t[:, None] * d, p)
            outward = torch.where(m, nt, outward)
            u = torch.where(is_t, uvt[:, 0], u)
            v = torch.where(is_t, uvt[:, 1], v)
            mat = torch.where(is_t, T.tmat[i], mat)
        if n_v:
            i = torch.where(is_v, idx, 0)
            pv = o + t[:, None] * d
            p = torch.where(is_v[:, None], pv, p)
            outward = torch.where(is_v[:, None],
                                  torch.tensor([1.0, 0.0, 0.0], device=dev,
                                               dtype=dt), outward)
            u, v = torch.where(is_v, 0.0, u), torch.where(is_v, 0.0, v)
            mat = torch.where(is_v, T.vmat[i], mat)
        miss = alive & ~hit
        radiance = radiance + torch.where(miss[:, None],
                                          throughput * T.background, 0.0)
        alive = alive & hit
        front = (_dot(d, outward) < 0.0) | is_v
        normal = torch.where(front[:, None], outward, -outward)
        sc = _scatter(T, mat, d, p, normal, front, u, v, seed, ray_id, depth,
                      has_noise, has_image)
        radiance = radiance + torch.where(alive[:, None],
                                          throughput * sc.emitted, 0.0)
        throughput = torch.where(alive[:, None], throughput * sc.attenuation,
                                 throughput)
        alive = alive & sc.alive
        o = torch.where(alive[:, None], p, o)
        d = torch.where(alive[:, None], sc.direction, d)
        if not bool(alive.any()):
            break
    return radiance, segments


def render_lanes(T: Tables, cam: dict, width: int, height: int, spp: int,
                 max_depth: int, lanes: torch.Tensor, seed: int, *,
                 log10: bool = True):
    """Radiance (n, 3) and segments (n,) of lanes (pixel * spp + sample)."""
    dt = T.c0.dtype
    o, d, time, ray_id = primary_rays(cam, width, height, spp, lanes, seed,
                                      dt)
    return trace(T, o, d, time, ray_id, seed, max_depth, log10=log10)


def render_pixels(T: Tables, cam: dict, width: int, height: int, spp: int,
                  max_depth: int, pixels: torch.Tensor, seed: int, *,
                  log10: bool = True, block: int = 1 << 15):
    """Sums over the spp samples of each pixel (n, 3), float32, traced in
    blocks of lanes so that the brute force fits."""
    lanes = (pixels[:, None] * spp + torch.arange(spp, device=pixels.device)
             ).reshape(-1)
    out = []
    with torch.no_grad():
        for s in range(0, lanes.shape[0], block):
            rad, _ = render_lanes(T, cam, width, height, spp, max_depth,
                                  lanes[s:s + block], seed, log10=log10)
            out.append(rad.float())
    return torch.cat(out).reshape(-1, spp, 3).sum(1)


def tf32_off() -> None:
    """The reference's matrix products in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
