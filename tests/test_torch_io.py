"""The port's front end against the JAX package: scene files, the pixel
stream, tile checkpoints, metrics, debug checks, live_view and the CLI.

Ports tests/test_scene_io.py (the npz round trip, here across the packages
in both directions: a file either saves, the other loads bit for bit and
renders the same), tests/test_stream.py (COBS and the messages, here also
byte for byte against the JAX encoders, Python's and native; the
tolerant receiver; stream_render against
render_image; live_view on a stream file), tests/test_aux.py:50 and :75
(tile store resume, measured_render and wavefront_occupancy) and
tests/test_debug.py, all on the CPU; then the CLI with --cpu: the PNG is
the tone-mapped render_image, --resume-dir renders only the missing tiles
and writes the same PNG, --stream writes a stream that decodes to it,
--mesh 2,1,1 under torchrun writes the single-rank PNG, and without a world
exits with an error.
"""

import os

import numpy as np
import pytest
import torch

from raytracer_weekend_tpu import integrator as JI
from raytracer_weekend_tpu import native as jnative
from raytracer_weekend_tpu.camera import make_camera as jmake_camera
from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.parallel import stream as JS
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu.scene import io as jio
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch.camera import make_camera as tmake_camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.parallel import stream as S
from raytracer_weekend_tpu_torch.scene import builder as TB
from raytracer_weekend_tpu_torch.scene import io as tio
from raytracer_weekend_tpu_torch.utils import cli, live_view
from raytracer_weekend_tpu_torch.utils.checkpoint import (
    TileStore, render_resumable)
from raytracer_weekend_tpu_torch.utils.debug import (
    SceneValidationError, check_render_finite, validate_scene)
from raytracer_weekend_tpu_torch.utils.image import tone_map
from raytracer_weekend_tpu_torch.utils.metrics import (
    measured_render, wavefront_occupancy)


def _io_objs(B):
    """tests/test_scene_io.py's scene: checker ground, glass, a uv-debug
    triangle and a medium."""
    return [
        B.Sphere((0, -100.5, -1), 100.0,
                 B.Lambertian(B.Checker(B.SolidColor((0.2, 0.3, 0.1)),
                                        B.SolidColor((0.9, 0.9, 0.9)), 10.0))),
        B.Sphere((0, 0, -1), 0.5, B.Dielectric(1.5)),
        B.Triangle.flat_shaded(((-2, 0, -2), (2, 0, -2), (0, 2, -2)),
                               B.Lambertian(B.UVDebug())),
        B.ConstantMedium(B.Sphere((1, 0.5, -1), 0.4,
                                  B.Lambertian((1, 1, 1))), 0.5,
                         B.SolidColor((0.5, 0.6, 0.7))),
    ]


def _npz_equal(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_scene_roundtrip_across_packages(tmp_path, direction):
    """A scene with both trees (bvh=True) saved by one package loads in the
    other: the same keys, dtypes and bits as the other's own file, the same
    static facts, and the port renders the loaded scene as the original."""
    ts, tst = TB.build_scene(_io_objs(TB), background=(0.6, 0.7, 0.9),
                             bvh=True)
    js, jst = JB.build_scene(_io_objs(JB), background=(0.6, 0.7, 0.9),
                             bvh=True)
    assert tst.triangle_bvh and tst.sphere_bvh
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    tio.save_scene(port_path, ts, tst)
    jio.save_scene(jax_path, js, jst)
    _npz_equal(port_path, jax_path)
    if direction == "port to jax":
        js2, jst2 = jio.load_scene(port_path)
        assert jst2 == jst
        jcfg = JConfig(width=8, height=4, samples_per_pixel=2, max_depth=3)
        jcam = jmake_camera((0, 0.3, 1.5), (0, 0, -1), (0, 1, 0), 50.0, 2.0,
                            0.0, 2.0, 0.0, 1.0)
        a = np.asarray(JI.render_image(js, jst, jcfg, jcam))
        b = np.asarray(JI.render_image(js2, jst2, jcfg, jcam))
        np.testing.assert_allclose(a, b, atol=1e-6)
        return
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3)
    cam = tmake_camera((0, 0.3, 1.5), (0, 0, -1), (0, 1, 0), 50.0, 2.0, 0.0,
                       2.0, 0.0, 1.0)
    ts2, tst2 = tio.load_scene(jax_path, device="cpu")
    assert tst2 == tst
    assert len(ts2.leaves()) == len(ts.leaves())
    for a, b in zip(ts2.leaves(), ts.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    a = TI.render_image(ts, tst, cfg, cam)
    b = TI.render_image(ts2, tst2, cfg, cam)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_load_scene_defaults_to_the_card(tmp_path):
    ts, tst = TB.build_scene(_io_objs(TB)[:2])
    path = str(tmp_path / "s.npz")
    tio.save_scene(path, ts, tst)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.load_scene(path)
    scene, _ = tio.load_scene(path, device="cpu")
    assert scene.sphere_bvh is None and scene.device.type == "cpu"


# ---- the wire protocol ------------------------------------------------------------

PAYLOADS = [b"", b"\x00", b"abc", b"a\x00b", b"\x00\x00",
            bytes(range(1, 256)) * 2, bytes(300), b"x" * 254, b"x" * 255]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_cobs_roundtrip(payload):
    """The port's codec and both of the JAX package's give the same bytes,
    and decode them back."""
    enc = S.cobs_encode(payload)
    assert enc == JS.cobs_encode(payload) == jnative.cobs_encode(payload)
    assert b"\x00" not in enc
    assert S.cobs_decode(enc) == jnative.cobs_decode(enc) == payload


def test_cobs_decode_rejects_malformed():
    for bad in (b"\x05ab", b"\x02a\x00"):
        with pytest.raises(ValueError):
            S.cobs_decode(bad)


MESSAGES = [S.ImageStart(400, 225, 100), S.Pixel(3, 7, (0.25, 0.5, 4.0)),
            S.Pixel(2**20, 2**14, (-1.0, 0.0, 1e9)), S.ImageEnd()]
JMESSAGES = [JS.ImageStart(400, 225, 100), JS.Pixel(3, 7, (0.25, 0.5, 4.0)),
             JS.Pixel(2**20, 2**14, (-1.0, 0.0, 1e9)), JS.ImageEnd()]


def test_message_roundtrip():
    """The messages' bytes are the JAX package's; the receiver rebuilds
    them."""
    blob = b"".join(S.encode_message(m) for m in MESSAGES)
    assert blob == b"".join(JS.encode_message(m) for m in JMESSAGES)
    rx = S.ImageReceiver()
    rx.feed(blob)
    assert rx.done
    assert rx.image.shape == (225, 400, 3)
    np.testing.assert_allclose(rx.image[3, 7], [0.25, 0.5, 4.0])
    assert rx.errors == 0


def test_receiver_tolerates_corruption():
    good = S.encode_message(S.ImageStart(4, 4, 1))
    junk = b"\x07garbage\x00" + b"\x02\x00"          # bad frames
    pix = S.encode_message(S.Pixel(1, 2, (1.0, 2.0, 3.0)))
    truncated = S.encode_message(S.Pixel(3, 3, (9, 9, 9)))[:-6]
    end = S.encode_message(S.ImageEnd())
    rx = S.ImageReceiver()
    rx.feed(good + junk + pix + truncated + b"\x00" + end)
    assert rx.done
    assert rx.pixels_received == 1
    assert rx.errors >= 1
    np.testing.assert_allclose(rx.image[1, 2], [1, 2, 3])


def test_resync_preamble_and_partial_frames():
    """Four 0x00 bytes are ignored, and a stream fed one byte at a time
    (a tailing reader's chunks end mid-frame) lands every pixel."""
    rx = S.ImageReceiver()
    rx.feed(b"\x00\x00\x00\x00" + S.encode_message(S.ImageStart(2, 2, 1)))
    assert rx.image is not None
    msgs = [S.ImageStart(3, 2, 1)]
    msgs += [S.Pixel(r, c, (r + 0.5, c + 0.5, 0.0))
             for r in range(2) for c in range(3)]
    msgs.append(S.ImageEnd())
    blob = b"".join(S.encode_message(m) for m in msgs)
    rx = S.ImageReceiver()
    for i in range(len(blob)):
        rx.feed(blob[i:i + 1])
    assert rx.done and rx.errors == 0 and rx.pixels_received == 6
    np.testing.assert_allclose(rx.image[1, 2], [1.5, 2.5, 0.0])


def _small():
    objs = [TB.Sphere((0, 0, -2), 0.6, TB.Lambertian((0.6, 0.3, 0.2)))]
    scene, static = TB.build_scene(objs, background=(0.7, 0.8, 1.0))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3)
    cam = tmake_camera((0, 0, 1), (0, 0, -2), (0, 1, 0), 40.0,
                       cfg.aspect_ratio, 0.0, 3.0, 0.0, 1.0)
    return scene, static, cfg, cam


def test_stream_render_matches_direct(tmp_path):
    """stream_render's sums are render_image's, its stream decodes to them;
    live_view on the stream file writes their tone map as a PNG."""
    from PIL import Image

    scene, static, cfg, cam = _small()
    chunks = []
    img = S.stream_render(scene, static, cfg, cam, chunks.append,
                          chunk_pixels=8)
    direct = TI.render_image(scene, static, cfg, cam).numpy()
    np.testing.assert_allclose(img, direct, atol=1e-5)
    rx = S.ImageReceiver()
    rx.feed(b"".join(chunks))
    assert rx.done and rx.pixels_received == cfg.n_pixels
    np.testing.assert_allclose(rx.image, direct, rtol=1e-6)

    src = tmp_path / "render.stream"
    src.write_bytes(b"".join(chunks[:2]) + b"\x05junk\x00"
                    + b"".join(chunks[2:]))
    out = tmp_path / "live.png"
    rx = live_view.run(str(src), str(out), follow=False, once=True,
                       quiet=True)
    assert rx.done and rx.pixels_received == cfg.n_pixels and rx.errors >= 1
    got = np.asarray(Image.open(out).convert("RGB"))
    np.testing.assert_array_equal(got, tone_map(direct, cfg.samples_per_pixel))
    out2 = tmp_path / "live2.png"
    assert live_view.main([str(src), "-o", str(out2), "--no-follow",
                           "--once"]) == 0
    assert out2.read_bytes() == out.read_bytes()


# ---- tile checkpoints and metrics --------------------------------------------------

def _setup():
    objs = [
        TB.Sphere((0, -100.5, -1), 100.0, TB.Lambertian((0.8, 0.8, 0.0))),
        TB.Sphere((0, 0, -1), 0.5, TB.Lambertian((0.1, 0.2, 0.5))),
    ]
    scene, static = TB.build_scene(objs, background=(0.6, 0.7, 0.9))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3,
                       seed=5)
    cam = tmake_camera((0, 0.2, 1.2), (0, 0, -1), (0, 1, 0), 50.0, 2.0, 0.0,
                       2.0, 0.0, 1.0)
    return scene, static, cfg, cam


def test_tile_store_resume(tmp_path):
    scene, static, cfg, cam = _setup()
    ref = TI.render_image(scene, static, cfg, cam).numpy()
    store = TileStore(str(tmp_path / "tiles"))
    img1 = render_resumable(scene, static, cfg, cam, store, tile_pixels=8)
    np.testing.assert_allclose(img1, ref, atol=1e-5)
    # Drop one tile; resume re-renders only the missing piece.
    victims = sorted(f for f in os.listdir(store.root) if f.endswith(".npy"))
    assert len(victims) == 4
    os.remove(os.path.join(store.root, victims[0]))
    rendered = []
    orig = TI.render_chunk
    try:
        TI.render_chunk = lambda *a, **k: rendered.append(1) or orig(*a, **k)
        img2 = render_resumable(scene, static, cfg, cam, store, tile_pixels=8)
    finally:
        TI.render_chunk = orig
    assert len(rendered) == 1
    np.testing.assert_array_equal(img2, img1)
    # A store of another config is refused.
    cfg2 = RenderConfig(width=8, height=4, samples_per_pixel=4, max_depth=3)
    with pytest.raises(ValueError, match="different config"):
        render_resumable(scene, static, cfg2, cam, store, tile_pixels=8)


def test_measured_render_and_occupancy():
    scene, static, cfg, cam = _setup()
    stats = measured_render(scene, static, cfg, cam)
    assert stats.primary_rays == cfg.n_rays
    assert stats.ray_segments >= cfg.n_rays  # every lane traces >= 1 segment
    assert 1.0 <= stats.mean_path_length <= cfg.max_depth
    assert "segments_per_s" in stats.json_line(config="test")
    occ = wavefront_occupancy(scene, static, cfg, cam, n_lanes=64)
    assert occ.shape == (cfg.max_depth,)
    assert occ[0] == 1.0            # all primaries alive at bounce 0
    assert (np.diff(occ) <= 1e-6).all()  # attrition is monotone
    seg = TI.trace_rays(scene, static, cfg, *TI._pixel_rays(
        cam, cfg, torch.arange(64), cfg.seed), cfg.seed, return_stats=True)[1]
    assert abs(float(occ.sum()) * 64 - int(seg)) < 1e-6


# ---- debug checks -----------------------------------------------------------------

def _debug_scene():
    objs = [TB.Sphere((0, 0, -2), 0.5, TB.Lambertian((0.5, 0.5, 0.5))),
            TB.Sphere((1, 0, -2), 0.5, TB.Metal((0.8, 0.8, 0.8), 0.3))]
    return TB.build_scene(objs)


@pytest.mark.parametrize("fault,match", [
    (None, None), ("nan center", "NaN"), ("bad material", "out of range"),
    ("oversized fuzz", "fuzz")])
def test_validate_scene(fault, match):
    scene, static = _debug_scene()
    if fault == "nan center":
        scene.spheres.c0[0, 0] = float("nan")
    elif fault == "bad material":
        scene.spheres.mat[0] = 99
    elif fault == "oversized fuzz":
        scene.materials.fuzz[1] = 2.0
    if fault is None:
        validate_scene(scene, static)
        return
    with pytest.raises(SceneValidationError, match=match):
        validate_scene(scene, static)


def test_check_render_finite():
    scene, static = _debug_scene()
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1, max_depth=2)
    cam = tmake_camera((0, 0, 1), (0, 0, -2), (0, 1, 0), 40.0, 2.0, 0.0, 3.0,
                       0.0, 1.0)
    colors = check_render_finite(scene, static, cfg, cam)
    assert colors.shape == (cfg.n_rays, 3) and np.isfinite(colors).all()
    scene.background[0] = float("nan")       # every lane that misses
    with pytest.raises(FloatingPointError, match="non-finite"):
        check_render_finite(scene, static, cfg, cam)


# ---- the CLI --------------------------------------------------------------------

def test_cli_cpu_png_resume_and_stream(tmp_path, capsys):
    """`cli two_spheres ... --cpu` writes image_0000.png, the tone map of
    render_image; --resume-dir writes the same PNG, and again after a tile
    is dropped; --stream's stream decodes to the same sums; --mesh 2,1,1
    without a world exits with an error naming the world size."""
    from PIL import Image

    args = ["two_spheres", "-w", "16", "-s", "2", "-d", "3", "--cpu"]
    assert cli.main(args + ["-o", str(tmp_path / "a")]) == 0
    cfg = RenderConfig.from_aspect(width=16, aspect_ratio=16 / 9,
                                   samples_per_pixel=2, max_depth=3)
    scene, static, cams = TS.generate_scene("two_spheres", cfg.aspect_ratio,
                                            device="cpu")
    sums = TI.render_image(scene, static, cfg, cams[0]).numpy()
    png = tmp_path / "a" / "image_0000.png"
    np.testing.assert_array_equal(np.asarray(Image.open(png).convert("RGB")),
                                  tone_map(sums, 2))
    tiles = tmp_path / "tiles"
    resume = args + ["--resume-dir", str(tiles), "-o", str(tmp_path / "b")]
    assert cli.main(resume) == 0
    assert (tmp_path / "b" / "image_0000.png").read_bytes() == png.read_bytes()
    os.remove(tiles / "f0000_t00000.npy")
    assert cli.main(resume) == 0
    assert (tmp_path / "b" / "image_0000.png").read_bytes() == png.read_bytes()
    stream = tmp_path / "s.stream"
    assert cli.main(args + ["--stream", str(stream), "-o",
                            str(tmp_path / "c")]) == 0
    rx = S.ImageReceiver()
    rx.feed(stream.read_bytes())
    assert rx.done and rx.pixels_received == cfg.n_pixels
    np.testing.assert_allclose(rx.image, sums, atol=1e-5)
    assert cli.main(args + ["--mesh", "2,1,1"]) == 2
    assert "world size is 1" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args[:-1] + ["-o", str(tmp_path / "d")])


def test_cli_mesh_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 2 -m raytracer_weekend_tpu_torch.utils.cli
    two_spheres ... --cpu --mesh 2,1,1` (a gloo world of two CPU ranks)
    writes the PNG of the single-rank CLI, byte for byte, from rank 0."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    args = ["two_spheres", "-w", "16", "-s", "2", "-d", "3", "--cpu"]
    assert cli.main(args + ["-o", str(tmp_path / "one")]) == 0
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "raytracer_weekend_tpu_torch.utils.cli",
         *args, "--mesh", "2,1,1", "-o", str(tmp_path / "mesh")],
        cwd=root, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "backend gloo" in run.stdout
    assert ((tmp_path / "mesh" / "image_0000.png").read_bytes()
            == (tmp_path / "one" / "image_0000.png").read_bytes())


def test_cli_defaults_match_jax():
    """The CLI's options and defaults are the JAX CLI's."""
    from raytracer_weekend_tpu.utils import cli as jcli

    def options(parser):
        return {a.dest: (a.default, a.option_strings)
                for a in parser._actions if a.dest != "help"}

    got, want = options(cli.build_parser()), options(jcli.build_parser())
    assert got.keys() == want.keys()
    for k in want:
        if k != "scene":
            assert got[k] == want[k], k
