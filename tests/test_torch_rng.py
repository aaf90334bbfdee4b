"""The port's PCG4D and samplers against the JAX package's.

`rand4` must be bit-equal: every sample of the renderer is keyed on
(seed, ray_id, depth, salt), and the CUDA kernel's device PCG4D is held
bit-equal to this plain torch version on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import rng as jrng
from raytracer_weekend_tpu_torch import rng as trng

SALTS = [trng.SALT_PIXEL_JITTER, trng.SALT_LENS, trng.SALT_TIME,
         trng.SALT_LAMBERTIAN, trng.SALT_METAL, trng.SALT_DIELECTRIC,
         trng.SALT_ISOTROPIC, trng.SALT_VOLUME]


def _ray_ids():
    """4096 ids: small, random 32-bit (many >= 2^31) and the edges."""
    r = np.random.default_rng(11)
    ids = np.concatenate([
        np.arange(1024, dtype=np.uint64),
        r.integers(0, 2**32, size=3068, dtype=np.uint64),
        np.array([2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64),
    ])
    assert ids.size == 4096 and (ids >= 2**31).sum() > 1000
    return ids.astype(np.uint32)


def test_salts_match():
    for name in ("SALT_PIXEL_JITTER", "SALT_LENS", "SALT_TIME",
                 "SALT_LAMBERTIAN", "SALT_METAL", "SALT_DIELECTRIC",
                 "SALT_ISOTROPIC", "SALT_VOLUME"):
        assert getattr(trng, name) == getattr(jrng, name)


def test_pcg4d_bits_equal():
    ids = _ray_ids()
    got = trng.pcg4d(torch.from_numpy(ids.astype(np.int64)), 5,
                     trng.SALT_METAL, 0xDEADBEEF)
    want = jrng.pcg4d(jnp.asarray(ids), 5, trng.SALT_METAL, 0xDEADBEEF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF])
def test_rand4_bit_equal(seed):
    ids = _ray_ids()
    tid = torch.from_numpy(ids.astype(np.int64))
    jid = jnp.asarray(ids)
    for salt in SALTS:
        for depth in range(50):
            got = trng.rand4(seed, tid, depth, salt).numpy()
            want = np.asarray(jrng.rand4(seed, jid, depth, salt))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_samplers_match():
    u = np.random.default_rng(5).random((4096, 3), dtype=np.float32)
    tu = [torch.from_numpy(u[:, k].copy()) for k in range(3)]
    ju = [jnp.asarray(u[:, k]) for k in range(3)]
    pairs = [
        (trng.unit_vector_from_uniforms(tu[0], tu[1]),
         jrng.unit_vector_from_uniforms(ju[0], ju[1])),
        (trng.in_unit_sphere_from_uniforms(*tu),
         jrng.in_unit_sphere_from_uniforms(*ju)),
        (trng.in_unit_disk_from_uniforms(tu[0], tu[1]),
         jrng.in_unit_disk_from_uniforms(ju[0], ju[1])),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
