"""The image-only deferred combine's plain versions (`image_combine.py`, the
twins of the kernel pair in `csrc/combine.cu`) against the JAX package's
`_combine_deferred` and its `jax.vjp`, and against the torch autograd of the
general combine that `fused_diff.combine_vjp` ran before.

Records: the plain forward's (K6a's twin) on the earth over a checker ground
(sphere image texels, the general combine) and on a scene with an image
rect and an image-textured light (planar image texels, emission at the
recording bounce), both at 24x16, 2 spp, depth 8; and synthetic records on
an atlas of two images of different sizes, with texels 0 in a channel,
lanes of 3 and more live records, all-dead lanes, zero records past a
lane's end and UVs outside [0, 1] and at the poles.

Tolerances: the JAX side takes a cumulative product and a sum along the
bounces, which round in another order than the port's running product
(1e-5 relative); the texel gradient is a sum over records in either order
(1e-4 of its largest entry). Against the torch autograd the records'
cotangents g_k are the same products, so equal; the texel gradient's
contributions are formed in another order, 1e-5 relative L1.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import textures as JT
from raytracer_weekend_tpu.ops.pallas.megakernel import _combine_deferred
from raytracer_weekend_tpu_torch import fused_diff
from raytracer_weekend_tpu_torch.ops.cuda import image_combine as ic
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk

from image_records import earth_checker, planar, rendered, synthetic

CASES = {"earth_checker": lambda: rendered(earth_checker),
         "planar": lambda: rendered(planar),
         "synthetic": synthetic}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    scene, static, ctb, abc, dcode = CASES[request.param]()
    if request.param == "planar":
        assert bool((dcode < 0).any() and (dcode > 0).any())
    assert int((dcode != 0).sum()) > 0
    return request.param, scene, static, ctb, abc, dcode


def _jax_combine(tex, ctb, abc, dcode, images=None, return_factors=False):
    """JAX `_combine_deferred` on the port's texture table (`images`, a JAX
    array, in place of its atlas) and records (ctb a JAX array)."""
    jt = JT.TextureTable(*(jnp.asarray(x.numpy()) for x in tex))
    if images is not None:
        jt = jt._replace(images=images)
    dfr = np.concatenate([abc.numpy(), dcode.numpy()[..., None]
                          .astype(np.float32)], -1)
    return _combine_deferred(types.SimpleNamespace(textures=jt), ctb,
                             jnp.asarray(dfr), has_noise=False,
                             has_image=True, return_factors=return_factors)


def test_combine_matches_jax(case):
    _, scene, _, ctb, abc, dcode = case
    tex = scene.textures
    rad, fac = ic.combine_images(tex, ctb, abc, dcode, return_factors=True)
    want_rad, want_fac = _jax_combine(tex, jnp.asarray(ctb.numpy()), abc,
                                      dcode, return_factors=True)
    np.testing.assert_allclose(rad.numpy(), np.asarray(want_rad), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(fac.numpy(), np.asarray(want_fac), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(ic.combine_images(tex, ctb, abc, dcode), rad)


def test_vjp_matches_jax(case):
    _, scene, _, ctb, abc, dcode = case
    tex = scene.textures
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(dcode.shape[0], 3)).astype(np.float32))
    g_k, d_images = ic.combine_images_vjp(tex, ctb, abc, dcode, g)
    _, vjp = jax.vjp(lambda c, im: _jax_combine(tex, c, abc, dcode, im),
                     jnp.asarray(ctb.numpy()), jnp.asarray(tex.images.numpy()))
    want_gk, want_img = (np.asarray(x) for x in vjp(jnp.asarray(g.numpy())))
    np.testing.assert_allclose(g_k.numpy(), want_gk, rtol=1e-5, atol=1e-6)
    scale = float(np.abs(want_img).max())
    assert scale > 0
    np.testing.assert_allclose(d_images.numpy(), want_img, rtol=0,
                               atol=1e-4 * scale)
    assert bool(torch.isfinite(d_images).all())
    # Without the texel gradient: the same g_k and no scatter.
    g_k2, none = ic.combine_images_vjp(tex, ctb, abc, dcode, g,
                                       texel_grad=False)
    assert none is None and torch.equal(g_k2, g_k)


def test_combine_vjp_matches_autograd(case):
    """`fused_diff.combine_vjp` on an image-only scene against the torch
    autograd of the general combine at the anchored abc (what it ran
    before): g_k equal, the texel gradient to 1e-5 relative L1, no
    cotangent of abc, every other wanted leaf None."""
    _, scene, static, ctb, abc, dcode = case
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(dcode.shape[0], 3)).astype(np.float32))
    images = scene.textures.images.clone().requires_grad_()
    color1 = scene.textures.color1.clone().requires_grad_()
    sc = scene._replace(textures=scene.textures._replace(images=images,
                                                         color1=color1))
    c = ctb.clone().requires_grad_()
    anchored = torch.where((dcode != 0)[..., None], abc, 0.5)
    rad = mk.combine_deferred(sc.textures, c, anchored, dcode,
                              has_noise=False, has_image=True)
    want_gk, want_img = torch.autograd.grad(rad, [c, images], g)
    g_k, cabc, grads = fused_diff.combine_vjp(sc, static, (ctb, abc, dcode),
                                              g, [images, color1])
    assert torch.equal(g_k, want_gk)
    assert cabc is None and grads[1] is None
    err = float((grads[0] - want_img).abs().sum() / want_img.abs().sum())
    assert err < 1e-5, err


def test_chained_calls_equal_one_call(case):
    """The depth phases' chain: the records split at bounces 3 and 6,
    combined with `init` and `return_factors`, give one call's rad and F
    bit for bit."""
    _, scene, _, ctb, abc, dcode = case
    tex = scene.textures
    want = ic.combine_images(tex, ctb, abc, dcode, return_factors=True)
    acc = None
    for lo, hi in ((0, 3), (3, 6), (6, dcode.shape[1])):
        acc = ic.combine_images(tex, ctb[:, lo:hi], abc[:, lo:hi],
                                dcode[:, lo:hi], init=acc,
                                return_factors=True)
    assert torch.equal(acc[0], want[0]) and torch.equal(acc[1], want[1])


def test_synthetic_lanes():
    """All-dead lanes sum their ctb and keep g_k = g; past a lane's end the
    records add nothing and g_k holds g * F; a texel 0 in a channel zeroes
    that channel of the later products, and the gradients stay finite."""
    scene, _, ctb, abc, dcode = synthetic()
    tex = scene.textures
    g = torch.ones((dcode.shape[0], 3))
    rad, fac = ic.combine_images(tex, ctb, abc, dcode, return_factors=True)
    g_k, d_images = ic.combine_images_vjp(tex, ctb, abc, dcode, g)
    dead = (dcode == 0).all(1)
    assert torch.equal(fac[dead], torch.ones_like(fac[dead]))
    assert torch.allclose(rad[dead], ctb[dead].sum(1), rtol=1e-6)
    assert torch.equal(g_k[dead], torch.ones_like(g_k[dead]))
    zero_rec = (ctb == 0).all(-1) & (dcode == 0)
    tail = zero_rec.flip(1).cumprod(1).flip(1).bool()  # zero to the end
    assert bool(tail.any())
    assert torch.equal(g_k[tail], (g[:, None] * fac[:, None]).expand_as(
        g_k)[tail])
    assert bool((fac == 0).any()) and bool(torch.isfinite(d_images).all())


def test_record_rows_view_or_pack():
    """K6a's single-pass records (views of one (n, D, 8) buffer) pass as that
    buffer without a copy; separate tensors are packed into the same rows."""
    n, D = 5, 4
    buf = torch.randn(n, D, mk.RECORD_COLS)
    codes = torch.randint(-3, 4, (n, D), dtype=torch.int32)
    buf.view(torch.int32)[..., 6] = codes
    views = (buf[..., 0:3], buf[..., 3:6], buf.view(torch.int32)[..., 6])
    rows = ic.record_rows(*views)
    assert rows.data_ptr() == buf.data_ptr()
    assert torch.equal(rows.view(torch.int32), buf.view(torch.int32))
    packed = ic.record_rows(*(v.contiguous() for v in views))
    assert packed.data_ptr() != buf.data_ptr()
    assert torch.equal(packed[..., :7].view(torch.int32),
                       buf[..., :7].view(torch.int32))
    assert bool((packed[..., 7] == 0).all())
