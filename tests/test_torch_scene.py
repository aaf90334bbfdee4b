"""The port's config, scene builder, camera and converter against the JAX ones."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import camera as jcam
from raytracer_weekend_tpu import config as jconfig
from raytracer_weekend_tpu.models import scenes as jscenes
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu_torch import camera as tcam
from raytracer_weekend_tpu_torch import config as tconfig
from raytracer_weekend_tpu_torch.models import scenes as tscenes
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import convert

ASPECT = 32 / 18


def _jax_scene(name):
    """The JAX build under bvh="auto", trees included (book2's 1,006
    spheres get one, as do the meshes' triangles)."""
    objs, cams, bg = getattr(jscenes, name)(ASPECT, seed=0)
    data, static = JB.build_scene(objs, background=bg, seed=0)
    return jax.tree_util.tree_map(np.asarray, data), static, cams[0]


def _torch_scene(name):
    objs, cams, bg = getattr(tscenes, name)(ASPECT, seed=0)
    data, static = TB.build_scene(objs, background=bg, seed=0)
    return data, static, cams[0]


def test_render_config_fields_match():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.RenderConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.RenderConfig)]
    assert tf == jf
    kw = dict(width=40, samples_per_pixel=3, max_depth=7, seed=9)
    j = jconfig.RenderConfig.from_aspect(**kw)
    t = tconfig.RenderConfig.from_aspect(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.aspect_ratio, t.n_pixels, t.n_rays) == (j.aspect_ratio, j.n_pixels,
                                                      j.n_rays)


def _assert_tables_equal(jdata, jstatic, tdata, tstatic):
    """Static facts equal, every table and tree bit-equal (Morton order
    included)."""
    assert dataclasses.asdict(tstatic) == dataclasses.asdict(jstatic)
    for tree in ("sphere_bvh", "triangle_bvh"):
        assert (getattr(tdata, tree) is None) == (getattr(jdata, tree) is None)
    for fam in ("spheres", "rects", "triangles", "volumes", "materials",
                "textures", "sphere_bvh", "triangle_bvh"):
        if getattr(jdata, fam) is None:
            continue
        jt, tt = getattr(jdata, fam), getattr(tdata, fam)
        assert tt._fields == jt._fields
        for f in jt._fields:
            want = np.asarray(getattr(jt, f))
            got = getattr(tt, f).numpy()
            assert got.dtype == want.dtype, (fam, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{fam}.{f}")
    np.testing.assert_array_equal(tdata.background.numpy(),
                                  np.asarray(jdata.background))


@pytest.mark.parametrize("name", ["jumpy_balls", "two_spheres",
                                  "smokey_cornell_box", "book2_final_scene",
                                  "textured_monument",
                                  "wavefront_suspension_obj"])
def test_builder_tables_bit_equal(name):
    jdata, jstatic, _ = _jax_scene(name)
    tdata, tstatic, _ = _torch_scene(name)
    _assert_tables_equal(jdata, jstatic, tdata, tstatic)
    if name == "jumpy_balls":
        assert tstatic.n_spheres == 486 and tstatic.fused_simple
    if name == "book2_final_scene":
        assert (tstatic.n_spheres, tstatic.n_rects, tstatic.n_volumes) == (
            1006, 2401, 2) and tstatic.fused_simple
        assert tstatic.sphere_bvh and not tstatic.triangle_bvh
    if name == "textured_monument":   # tests/test_scenes.py:50
        assert (tstatic.n_rects, tstatic.n_triangles) == (1, 7798)
        assert tstatic.fused_simple and tstatic.triangle_bvh
    if name == "wavefront_suspension_obj":  # vertex normals, a tree
        assert tstatic.n_triangles == 17190 and tstatic.fused_simple
        assert tstatic.triangle_bvh and tdata.triangle_bvh.prim.shape == (
            2 * 17190 - 1,)


def test_objloader_image_map_bit_equal():
    """models/capsule.obj's map_Kd (capsule0.jpg) is readable: both loaders
    build Lambertian(ImageTexture) on 10,200 triangles, and the two builds'
    tables, the image atlas included, are bit-equal."""
    from raytracer_weekend_tpu.scene import objloader as jobj
    from raytracer_weekend_tpu_torch.scene import objloader as tobj

    path = tscenes.model_path("capsule.obj")
    jtris, ttris = jobj.load_wavefront_obj(path), tobj.load_wavefront_obj(path)
    assert len(ttris) == len(jtris) == 10200
    assert isinstance(ttris[0].material.albedo, TB.ImageTexture)
    jdata, jstatic = JB.build_scene(jtris)
    tdata, tstatic = TB.build_scene(ttris)
    assert tstatic.has_image and tstatic.n_triangles == 10200
    assert tstatic.triangle_bvh
    _assert_tables_equal(jax.tree_util.tree_map(np.asarray, jdata), jstatic,
                         tdata, tstatic)


def test_builder_rejects_unported_objects():
    """An unknown object raises; bvh "auto", True and False give JAX's
    trees and flags on both sides of each threshold (512 spheres, 64
    triangles)."""
    with pytest.raises(NotImplementedError):
        TB.build_scene([object()])
    g = np.random.default_rng(5)
    cs, vs = g.normal(size=(513, 3)) * 6, g.normal(size=(65, 3, 3)) * 2

    def objs(B, n_sph, n_tri):
        mat = B.Lambertian((0.5, 0.5, 0.5))
        return ([B.Sphere(tuple(c), 0.3, mat) for c in cs[:n_sph]]
                + [B.Triangle.flat_shaded(v, mat) for v in vs[:n_tri]])

    for n_sph, n_tri in ((512, 64), (513, 65)):
        for bvh in ("auto", True, False):
            jdata, jstatic = JB.build_scene(objs(JB, n_sph, n_tri), bvh=bvh)
            tdata, tstatic = TB.build_scene(objs(TB, n_sph, n_tri), bvh=bvh)
            _assert_tables_equal(jax.tree_util.tree_map(np.asarray, jdata),
                                 jstatic, tdata, tstatic)
            built = bvh is True or (bvh == "auto" and n_sph > 512)
            assert tstatic.sphere_bvh == built == tstatic.triangle_bvh


@pytest.mark.parametrize("kw", [
    dict(look_from=(13, 2, 3), look_at=(0, 0, 0), vertical_field_of_view=20.0,
         aspect_ratio=16 / 9, aperture=0.1),
    dict(look_from=(278, 278, -800), look_at=(278, 278, 0),
         vertical_field_of_view=40.0, aspect_ratio=1.0),
    dict(look_from=(-5, -30, 25), look_at=(0, 0, 5), up_vector=(1, 0, 0),
         vertical_field_of_view=40.0, aspect_ratio=1.5, time0=0.25, time1=0.75),
])
def test_make_camera_matches(kw):
    j = jcam.make_camera(**kw)
    t = tcam.make_camera(**kw)
    for f in jcam.Camera._fields:
        got = getattr(t, f)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-6, atol=1e-6)


def test_convert_round_trips():
    jdata, jstatic, jc = _jax_scene("jumpy_balls")
    scene = convert.scene_from_numpy(jdata)
    static = convert.static_from_dict(dataclasses.asdict(jstatic))
    cam = convert.camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc))
    tdata, tstatic, tc = _torch_scene("jumpy_balls")
    assert static == tstatic
    for fam in ("spheres", "materials", "textures", "rects", "volumes"):
        for a, b in zip(getattr(scene, fam), getattr(tdata, fam)):
            assert torch.equal(a, b)
    # port -> numpy -> port is the identity, and so is the dict form.
    back = convert.scene_from_numpy(convert.scene_to_numpy(scene))
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(tuple(scene))):
        assert torch.equal(a, b)
    assert convert.static_from_dict(dataclasses.asdict(static)) == static
    cam2 = convert.camera_from_numpy(convert.camera_to_numpy(cam))
    for a, b in zip(cam2, cam):
        assert torch.equal(a, b)
    for a, b in zip(cam, tc):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import raytracer_weekend_tpu_torch\n"
            "from raytracer_weekend_tpu_torch import integrator, rng, camera\n"
            "from raytracer_weekend_tpu_torch import replay, fused_diff, train\n"
            "from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd\n"
            "from raytracer_weekend_tpu_torch.models import scenes\n"
            "from raytracer_weekend_tpu_torch.scene import builder, convert\n"
            "from raytracer_weekend_tpu_torch.scene import objloader\n"
            "from raytracer_weekend_tpu_torch.ops import rect, triangle\n"
            "from raytracer_weekend_tpu_torch.ops.cuda import megakernel, _build\n"
            "from raytracer_weekend_tpu_torch.utils import image\n"
            "from raytracer_weekend_tpu_torch.ops.cuda import perlin_turb\n"
            "from raytracer_weekend_tpu_torch.ops.cuda import (\n"
            "    sphere_intersect, rect_intersect, triangle_intersect)\n"
            "from raytracer_weekend_tpu_torch.ops.cuda import checks\n"
            "from raytracer_weekend_tpu_torch.ops.cuda import bvh_traverse\n"
            "from raytracer_weekend_tpu_torch import native\n"
            "from raytracer_weekend_tpu_torch.ops import bvh, collectives\n"
            "from raytracer_weekend_tpu_torch.scene import io\n"
            "from raytracer_weekend_tpu_torch.parallel import stream\n"
            "from raytracer_weekend_tpu_torch.parallel import (\n"
            "    mesh, multihost, shard)\n"
            "mesh.make_render_mesh((1, 1, 1), device='cpu')\n"
            "from raytracer_weekend_tpu_torch.utils import (\n"
            "    checkpoint, cli, debug, live_view, metrics)\n"
            "stream.encode_message(stream.ImageEnd())\n"
            "scenes.generate_scene('two_spheres', 1.5, device='cpu')\n"
            "scenes.generate_scene('textured_monument', 1.5, device='cpu')\n"
            "scenes.generate_scene('wavefront_cow_obj', 1.5, device='cpu')\n"
            "scenes.generate_scene('simple_light', 1.5, device='cpu')\n"
            "scenes.generate_scene('book2_final_scene', 1.5, device='cpu')\n"
            "from raytracer_weekend_tpu_torch.ops import volume\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
            "assert 'raytracer_weekend_tpu' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
