"""Image-only deferred records for the tests of `ops/cuda/image_combine.py`
(the CPU tests against JAX, and the card's tests against the plain
versions): scenes whose deferred texels are image texels only, their
records from the plain forward, and synthetic records with the edge cases.
Imports nothing of JAX."""

import numpy as np
import torch

from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models.scenes import _cam, _checker, earthmap
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.scene import builder as B

CFG = RenderConfig(width=24, height=16, samples_per_pixel=2, max_depth=8,
                   seed=3)


def earth_checker():
    """The earth over a checker ground (rtbench's `earth` scene): the
    general combine of sphere image texels."""
    earth = B.Lambertian(B.ImageTexture(data=earthmap()))
    objs = [B.Sphere((0, 0, 0), 2.0, earth),
            B.Sphere((0, -1002, 0), 1000.0, B.Lambertian(_checker()))]
    cam = _cam((13, 2, 3), (0, 0, 0), 20.0, CFG.aspect_ratio, 0.1, 10.0)
    return objs, cam, (0.7, 0.8, 1.0)


def planar():
    """The earth and a checker ground, an image rect and an image-textured
    light rect: planar image texels, and a texel at an emitting bounce."""
    rng = np.random.default_rng(1)
    small = rng.uniform(0.0, 1.0, (40, 60, 3)).astype(np.float32)
    small[:, :30, 1] = 0.0                  # texels 0 in a channel
    objs = [B.Sphere((0, -1000, 0), 1000.0, B.Lambertian(_checker())),
            B.Sphere((0, 2, 0), 2.0,
                     B.Lambertian(B.ImageTexture(data=earthmap()))),
            B.XYRectangle(-6.0, 6.0, 0.0, 6.0, -3.0,
                          B.Lambertian(B.ImageTexture(data=small))),
            B.XYRectangle(3.0, 5.0, 1.0, 3.0, 2.5,
                          B.DiffuseLight(B.ImageTexture(data=small)))]
    cam = _cam((26, 3, 6), (0, 2, 0), 20.0, CFG.aspect_ratio)
    return objs, cam, (0.2, 0.2, 0.3)


def rendered(make):
    """The plain forward's records of `make`'s scene at CFG, with a band of
    the atlas's texels 0 in a channel -> (scene, static, ctb, abc,
    dcode)."""
    objs, cam, bg = make()
    scene, static = B.build_scene(objs, background=bg)
    assert static.has_image and not static.has_noise
    assert not static.defer_single_hit
    _, _, ctb, abc, dcode = mk.records_reference(
        scene, CFG, cam, 0, CFG.n_rays, CFG.seed, static=static)
    images = scene.textures.images.clone()
    images[:, :100, :, 2] = 0.0             # texels 0 in a channel
    scene = scene._replace(textures=scene.textures._replace(images=images))
    return scene, static, ctb, abc, dcode


def synthetic(device="cpu"):
    """Records on `planar`'s textures (two images, the smaller padded):
    lanes 0-7 all dead, 8-15 with 3 to 8 live records, the rest random;
    each lane's records past a random end are zero."""
    scene, static = B.build_scene(planar()[0])
    tex = scene.textures
    image_tex = [i + 1 for i, t in enumerate(tex.ttype.tolist())
                 if t == 3]
    assert len(set(tex.image_id[[c - 1 for c in image_tex]].tolist())) >= 2
    rng = np.random.default_rng(7)
    n, D = 96, 10
    live = rng.uniform(size=(n, D)) < 0.35
    live[:8] = False
    live[8:16, [0, 3, 5]] = True
    end = rng.integers(1, D + 1, n)
    end[8:16] = D
    past = np.arange(D)[None, :] >= end[:, None]
    keep = live & ~past
    code = rng.choice(image_tex, size=(n, D))
    code = np.where(rng.uniform(size=(n, D)) < 0.5, code, -code)
    abc = rng.normal(size=(n, D, 3))
    abc /= np.linalg.norm(abc, axis=-1, keepdims=True)
    abc[:, 0] = [0.0, 1.0, 0.0]             # the pole: the clip of acos
    abc[:, 1] = [0.3, -1.0, 0.0]
    flat = code < 0
    abc[flat] = np.stack([rng.uniform(-0.1, 1.1, flat.sum()),
                          rng.uniform(-0.1, 1.1, flat.sum()),
                          np.zeros(flat.sum())], -1)
    ctb = rng.uniform(0.0, 2.0, (n, D, 3)) * (rng.uniform(size=(n, D, 1))
                                              < 0.4)
    dcode = np.where(keep, code, 0).astype(np.int32)
    abc = np.where(keep[..., None], abc, 0.0).astype(np.float32)
    ctb = np.where(past[..., None], 0.0, ctb).astype(np.float32)
    images = tex.images.clone()
    images[..., 0] *= torch.from_numpy(
        rng.uniform(size=images.shape[:3]) < 0.5).float()
    scene = scene._replace(textures=tex._replace(images=images))
    assert (keep.sum(1) >= 3).sum() >= 8 and (keep.sum(1) == 0).sum() >= 8
    return (scene.to(device), static,
            *(torch.from_numpy(x).to(device) for x in (ctb, abc, dcode)))
