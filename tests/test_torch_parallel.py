"""The port's render mesh (parallel/mesh, shard, multihost) on the CPU.

Ports tests/test_parallel.py and tests/test_multihost.py (both `slow`, so
tier-1 never runs them) to a gloo world of 8 CPU ranks, spawned once for
the module: every rank runs every case in turn (this file run as a script,
one process a rank), and each world's rank 0 writes the results that the
tests below read. After the 8-rank cases the ranks re-form into worlds of 4
and then of 2 for the meshes of that size (a mesh spans its whole world).

The sharded renders are held to the port's single-device `render_image` at
JAX's 2e-5, the single-device render to JAX's within the staged budget of
tests/test_torch_bvh.py; the per-shard trees to the blocks of JAX's
`pad_scene_for_geom` bit for bit; the sharded gradients to the port's
single-device gradient, leaf by leaf.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from raytracer_weekend_tpu_torch import integrator as TI  # noqa: E402
from raytracer_weekend_tpu_torch import train  # noqa: E402
from raytracer_weekend_tpu_torch.camera import make_camera  # noqa: E402
from raytracer_weekend_tpu_torch.config import RenderConfig  # noqa: E402
from raytracer_weekend_tpu_torch.parallel import mesh as M  # noqa: E402
from raytracer_weekend_tpu_torch.parallel import shard  # noqa: E402
from raytracer_weekend_tpu_torch.scene import builder as TB  # noqa: E402

WORLD = 8
MESH_SHAPES = [(8, 1, 1), (1, 8, 1), (1, 1, 8), (2, 2, 2), (4, 1, 2)]
BVH_SHAPES = [(1, 1, 8), (2, 1, 4), (2, 2, 2)]
# A 13x7 frame: 91 pixels, which neither 8 nor 2 rays ranks divide, so the
# last pixel block runs past the frame (on the staged path, as every CPU
# render and every geometry mesh takes).
RAGGED_SHAPES = [(8, 1, 1), (2, 1, 4)]
# (first rank, shape, scene) of the later, smaller worlds: the train step
# and InverseRenderer on meshes with an spp and a geom axis.
TRAIN_WORLDS = [(0, (2, 2, 1), "train"), (4, (2, 1, 2), "bvh")]
ONCE_WORLDS = [(0, (1, 2, 1), "train"), (2, (1, 1, 2), "train"),
               (4, (1, 2, 1), "bvh"), (6, (1, 1, 2), "bvh")]
STEPS, LR = 3, 3.0
NORM_REL = 1e-5


def _objs(B):
    """tests/test_parallel.py's `_scene` objects: a checker ground, three
    spheres, a uv-debug triangle and a light."""
    return [
        B.Sphere((0, -100.5, -1), 100.0,
                 B.Lambertian(B.Checker(B.SolidColor((0.2, 0.3, 0.1)),
                                        B.SolidColor((0.9, 0.9, 0.9)), 10.0))),
        B.Sphere((0, 0, -1), 0.5, B.Lambertian((0.1, 0.2, 0.5))),
        B.Sphere((-1, 0, -1), 0.5, B.Dielectric(1.5)),
        B.Sphere((1, 0, -1), 0.5, B.Metal((0.8, 0.6, 0.2), 0.2)),
        B.Triangle.flat_shaded(((-2, 0, -2.5), (2, 0, -2.5), (0, 2, -2.5)),
                               B.Lambertian(B.UVDebug())),
        B.XYRectangle(-0.5, 0.5, 1.0, 1.8, -2.0, B.DiffuseLight((3, 3, 3))),
    ]


def scene_of(kind: str, B=TB, make_cam=make_camera, Config=RenderConfig):
    """(scene, static, cfg, cam) of tests/test_parallel.py: "auto" and
    "bvh" its `_scene(bvh)` at 12x6x4 d4, "ragged" the "auto" scene at
    13x7x4 d4, "train" its train scene at 6x3x2 d2; built by the port, or
    by JAX given its builder."""
    if kind == "train":
        objs = [B.Sphere((0, -100.5, -1), 100.0,
                         B.Lambertian((0.8, 0.8, 0.0))),
                B.Sphere((0, 0, -1), 0.5, B.Lambertian((0.1, 0.2, 0.5)))]
        scene, static = B.build_scene(objs, background=(0.6, 0.7, 0.9))
        cfg = Config(width=6, height=3, samples_per_pixel=2, max_depth=2,
                     seed=5)
        cam = make_cam((0, 0.2, 1.2), (0, 0, -1), (0, 1, 0), 50.0, 2.0, 0.0,
                       2.0, 0.0, 1.0)
        return scene, static, cfg, cam
    scene, static = B.build_scene(_objs(B),
                                  background=(0.6, 0.7, 0.9),
                                  bvh=True if kind == "bvh" else "auto")
    cfg = Config(width=13 if kind == "ragged" else 12,
                 height=7 if kind == "ragged" else 6,
                 samples_per_pixel=4, max_depth=4, seed=5)
    cam = make_cam((0, 0.4, 1.5), (0, 0.2, -1), (0, 1, 0), 50.0,
                   cfg.aspect_ratio, 0.0, 2.0, 0.0, 1.0)
    return scene, static, cfg, cam


def perturbed(scene):
    """The train start of tests/test_parallel.py: color1 of texture 1 set
    to (0.9, 0.9, 0.9)."""
    c1 = scene.textures.color1.clone()
    c1[1] = torch.tensor([0.9, 0.9, 0.9])
    return scene._replace(textures=scene.textures._replace(color1=c1))


def target_of(kind):
    """The fit's target: the single-device render of the true scene / spp."""
    scene, static, cfg, cam = scene_of(kind)
    return TI.render_image(scene, static, cfg, cam) / cfg.samples_per_pixel


def _key(shape, kind=""):
    return "x".join(map(str, shape)) + (f"_{kind}" if kind else "")


# ---- the worker: one rank of the world ------------------------------------------

def _join(out: pathlib.Path, name: str, rank: int, size: int):
    M.distributed_init(device="cpu", init_method=f"file://{out / name}",
                       rank=rank, world_size=size, timeout_s=120)


def _row_boxes(fam, table):
    """(lo, hi) of each row of a local table: a sphere over the shutter
    with |radius|, a triangle over its vertices."""
    if fam == "spheres":
        r = table.radius.abs()[:, None]
        return (torch.minimum(table.c0, table.c1) - r,
                torch.maximum(table.c0, table.c1) + r)
    v = torch.stack([table.v0, table.v1, table.v2], dim=1)
    return v.amin(dim=1), v.amax(dim=1)


def _tree_facts(local, static, cfg, g):
    """This geometry rank's routes and whether each tree is its slice's:
    every local row a leaf exactly once, and each leaf's box holding that
    row of this rank's slice."""
    facts = {"routes": TI.hit_routes(local, static, cfg, "cpu"), "g": g}
    for fam, tree, table in (("spheres", local.sphere_bvh, local.spheres),
                             ("triangles", local.triangle_bvh,
                              local.triangles)):
        rows = table[0].shape[0]
        leaf = tree.prim >= 0
        prim = tree.prim[leaf].long()
        lo, hi = _row_boxes(fam, table)
        facts[fam] = bool(sorted(prim.tolist()) == list(range(rows))
                          and (tree.bmin[leaf] <= lo[prim]).all()
                          and (tree.bmax[leaf] >= hi[prim]).all())
    return facts


def _worker(rank: int, out: pathlib.Path) -> None:
    torch.set_num_threads(1)
    lead = rank == 0
    _join(out, "store8", rank, WORLD)
    # 1. Renders on the five JAX mesh shapes, the trees' shapes and the
    # ragged frame's.
    for kind, shapes in (("auto", MESH_SHAPES), ("bvh", BVH_SHAPES),
                         ("ragged", RAGGED_SHAPES)):
        scene, static, cfg, cam = scene_of(kind)
        for shape in shapes:
            rmesh = M.make_render_mesh(shape, device="cpu")
            with torch.no_grad():
                img, segs = shard.render_sharded(scene, static, cfg, cam,
                                                 rmesh, return_segments=True)
            if lead:
                np.save(out / f"render_{_key(shape, kind)}.npy", img.numpy())
                (out / f"segments_{_key(shape, kind)}.json").write_text(
                    json.dumps(int(segs)))
            if kind == "bvh":
                g = rmesh.coord[2]
                local = shard.shard_scene(scene, rmesh.n_geom, g)
                (out / f"trees_{_key(shape)}_{rank}.json").write_text(
                    json.dumps(_tree_facts(local, static, cfg, g)))
    # 2. A shape must span the world.
    if lead:
        errors = {}
        for shape in ((2, 2, 1), (4, 2, 2)):
            try:
                M.make_render_mesh(shape, device="cpu")
                errors[_key(shape)] = ""
            except ValueError as e:
                errors[_key(shape)] = str(e)
        (out / "errors.json").write_text(json.dumps(errors))
    M.dist.destroy_process_group()

    # 3. Worlds of 4: gradients and 3 SGD steps on (2,2,1) and (2,1,2).
    # 4. Worlds of 2: the loss counted once on an spp and a geom axis.
    for stage, worlds in (("train", TRAIN_WORLDS), ("once", ONCE_WORLDS)):
        size = 8 // len(worlds)
        first, shape, kind = worlds[rank // size]
        _join(out, f"store_{stage}_{first}", rank - first, size)
        scene, static, cfg, cam = scene_of(kind)
        start, target = perturbed(scene), target_of(kind)
        rmesh = M.make_render_mesh(shape, device="cpu")
        ir = train.InverseRenderer(static, cfg, cam, target, rmesh=rmesh)
        loss, grads = ir.value_and_grad(start)
        losses, steps, s = [], [], start
        for _ in range(STEPS if stage == "train" else 1):
            s, step_loss = shard.train_step(s, static, cfg, cam, target,
                                            rmesh, lr=LR)
            losses.append(float(step_loss))
            steps.append([t for t in s.leaves() if t.is_floating_point()])
        if rank == first:
            torch.save({"loss": loss, "grads": grads, "losses": losses,
                        "first_step": steps[0]},
                       out / f"{stage}_{_key(shape, kind)}.pt")
        M.dist.destroy_process_group()
    (out / f"done_{rank}").write_text("ok")


# ---- the world, once for the module --------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log.decode(errors="replace"))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + logs[bad[0]][-4000:]
    assert all((out / f"done_{r}").exists() for r in range(WORLD))
    print(f"mesh world of {WORLD} ranks: {time.time() - t0:.1f} s")
    return out


@pytest.fixture(scope="module")
def singles():
    """The port's single-device frames and traced segments, and JAX's."""
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator as JI
    from raytracer_weekend_tpu.camera import make_camera as jmake_camera
    from raytracer_weekend_tpu.config import RenderConfig as JConfig
    from raytracer_weekend_tpu.scene import builder as JB

    out = {}
    for kind in ("auto", "bvh", "ragged"):
        scene, static, cfg, cam = scene_of(kind)
        img = TI.render_image(scene, static, cfg, cam).numpy()
        ids = torch.arange(cfg.n_rays)
        _, seg = TI.render_chunk(scene, static, cfg, cam, ids, cfg.seed,
                                 return_stats=True)
        out[kind] = (img, int(seg))
    js, jst, jc, jcam = scene_of("auto", JB, jmake_camera, JConfig)
    jimg = np.asarray(JI.render_image(js, jst, jc, jcam))
    o, d, tm, rid = JI._pixel_rays(jcam, jc, jnp.arange(jc.n_rays,
                                                        dtype=jnp.int32),
                                   jnp.uint32(jc.seed))
    _, jseg = JI.trace_rays(js, jst, jc, o, d, tm, rid, jnp.uint32(jc.seed),
                            return_stats=True)
    out["jax"] = (jimg, int(jseg))
    return out


def _flips(got, ref, got_seg, ref_seg):
    """tests/test_torch_bvh.py's staged budget's readings: |dseg|, pixels
    off by more than 5% relative, the mean abs error."""
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-3)
    bad = len(np.unique(np.argwhere(rel > 0.05)[:, :2], axis=0))
    return abs(got_seg - ref_seg), bad, float(np.abs(got - ref).mean())


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_matches_single_device(world, singles, shape):
    """The sharded frame (and its traced segments) is the single-device
    render_image within JAX's 2e-5 (tests/test_parallel.py), and the
    single-device frame is JAX's within the staged budget."""
    ref, ref_seg = singles["auto"]
    img = np.load(world / f"render_{_key(shape, 'auto')}.npy")
    np.testing.assert_allclose(img, ref, rtol=2e-5, atol=2e-5)
    assert json.loads((world / f"segments_{_key(shape, 'auto')}.json")
                      .read_text()) == ref_seg
    jimg, jseg = singles["jax"]
    n = ref.shape[0] * ref.shape[1]
    dseg, bad, mean = _flips(ref, jimg, ref_seg, jseg)
    assert dseg <= max(2, n // 500) and bad <= max(2, n // 500), (dseg, bad)
    assert mean < 1e-4, mean


@pytest.mark.parametrize("shape", BVH_SHAPES)
def test_geom_sharded_bvh_matches(world, singles, shape):
    """Per-shard trees: the geometry-sharded frame of the scene built with
    bvh=True is its single-device frame within 2e-5; every geometry rank
    walks trees (route "tree" for spheres and triangles), each over its own
    slice's rows."""
    ref, ref_seg = singles["bvh"]
    img = np.load(world / f"render_{_key(shape, 'bvh')}.npy")
    np.testing.assert_allclose(img, ref, rtol=2e-5, atol=2e-5)
    assert json.loads((world / f"segments_{_key(shape, 'bvh')}.json")
                      .read_text()) == ref_seg
    gs = set()
    for rank in range(WORLD):
        facts = json.loads((world / f"trees_{_key(shape)}_{rank}.json")
                           .read_text())
        assert facts["routes"]["spheres"] == "tree", facts
        assert facts["routes"]["triangles"] == "tree", facts
        assert facts["spheres"] and facts["triangles"], facts
        gs.add(facts["g"])
    assert gs == set(range(shape[2]))


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_blocks_match_single_device(world, singles, shape):
    """A 13x7 frame on 8 and on 2 rays ranks: the last rank's pixel block
    runs past the frame (7 of 12 pixels on 8 ranks, 45 of 46 on 2), and
    the sharded frame is still the single-device render_image within 2e-5,
    with the same traced segments: the trimmed pixels are neither traced
    nor summed into the frame."""
    ref, ref_seg = singles["ragged"]
    n_pix = ref.shape[0] * ref.shape[1]
    assert n_pix % shape[0] != 0
    img = np.load(world / f"render_{_key(shape, 'ragged')}.npy")
    assert img.shape == ref.shape
    np.testing.assert_allclose(img, ref, rtol=2e-5, atol=2e-5)
    assert json.loads((world / f"segments_{_key(shape, 'ragged')}.json")
                      .read_text()) == ref_seg


@pytest.mark.parametrize("n_geom", [2, 4, 8])
def test_shard_trees_bit_equal_jax(n_geom):
    """pad_scene_for_geom's tables are JAX's bit for bit, and geometry rank
    g's tree (shard_scene) is the g-th block of JAX's stacked per-shard
    trees less its padding nodes (bmin +inf, bmax -inf, prim -1), on
    tests/test_parallel.py's scene with bvh=True and on the cow."""
    from raytracer_weekend_tpu.camera import make_camera as jmake_camera
    from raytracer_weekend_tpu.config import RenderConfig as JConfig
    from raytracer_weekend_tpu.models import scenes as JS
    from raytracer_weekend_tpu.parallel import shard as jshard
    from raytracer_weekend_tpu.scene import builder as JB
    from raytracer_weekend_tpu_torch.models import scenes as TS

    js = scene_of("bvh", JB, jmake_camera, JConfig)[0]
    ts = scene_of("bvh")[0]
    jo, _, jbg = JS.wavefront_cow_obj(16 / 9)
    to, _, tbg = TS.wavefront_cow_obj(16 / 9)
    cows = (JB.build_scene(jo, background=jbg, bvh=True)[0],
            TB.build_scene(to, background=tbg, bvh=True)[0])
    for jscene, tscene in ((js, ts), cows):
        jp = jshard.pad_scene_for_geom(jscene, n_geom)
        tp = shard.pad_scene_for_geom(tscene, n_geom)
        for fam in ("spheres", "triangles"):
            for jf, tf in zip(getattr(jp, fam), getattr(tp, fam)):
                np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        for fam, attr in (("spheres", "sphere_bvh"),
                          ("triangles", "triangle_bvh")):
            jtree = getattr(jp, attr)
            assert (jtree is None) == (getattr(tscene, attr) is None)
            if jtree is None:
                continue
            m_max = jtree.prim.shape[0] // n_geom
            for g in range(n_geom):
                ttree = getattr(shard.shard_scene(tscene, n_geom, g), attr)
                m = ttree.prim.shape[0]
                block = [np.asarray(f)[g * m_max:(g + 1) * m_max]
                         for f in jtree]
                for jf, tf in zip(block, ttree):
                    np.testing.assert_array_equal(tf.numpy(), jf[:m])
                assert (block[2][m:] == -1).all()
                assert np.isposinf(block[0][m:]).all()


def _norm_rel_ok(grads, ref):
    """Every float leaf's gradient within NORM_REL of the reference's,
    ||got - ref|| / ||ref|| (a leaf whose reference gradient is 0: against
    the largest leaf's norm)."""
    top = max(float(torch.linalg.vector_norm(r)) for r in ref)
    assert top > 0
    for i, (g, r) in enumerate(zip(grads, ref)):
        scale = float(torch.linalg.vector_norm(r)) or top
        err = float(torch.linalg.vector_norm(g - r))
        assert err <= NORM_REL * scale, (i, err, scale)


def _single(kind, got):
    """The single-device loss and gradients from the same start, and
    train_step's first update checked against them: every float leaf moved
    by -LR times the single-device gradient."""
    scene, static, cfg, cam = scene_of(kind)
    start = perturbed(scene)
    ir = train.InverseRenderer(static, cfg, cam, target_of(kind))
    loss, grads = ir.value_and_grad(start)
    floats = [t for t in start.leaves() if t.is_floating_point()]
    for new, p, g in zip(got["first_step"], floats, grads):
        torch.testing.assert_close(new, p - LR * g, rtol=1e-5, atol=1e-6)
    assert got["losses"][0] == pytest.approx(loss, rel=1e-5)
    return loss, grads


@pytest.mark.parametrize("shape,kind", [(s, k) for _, s, k in TRAIN_WORLDS])
def test_train_step_matches_single_device(world, shape, kind):
    """On (2,2,1) (the train scene) and (2,1,2) (the scene with bvh=True):
    InverseRenderer(rmesh)'s loss and gradients are the single-device ones
    (NORM_REL per leaf), train_step's first update is the single-device
    SGD step, and the loss falls over three steps at lr 3
    (tests/test_parallel.py's assertions)."""
    got = torch.load(world / f"train_{_key(shape, kind)}.pt")
    loss, grads = _single(kind, got)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _norm_rel_ok(got["grads"], grads)
    losses = got["losses"]
    assert np.isfinite(losses).all()
    if kind == "train":
        assert losses[-1] < losses[0] * 0.95, losses
    else:
        assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("shape,kind", [(s, k) for _, s, k in ONCE_WORLDS])
def test_train_step_counts_the_loss_once(world, shape, kind):
    """Every rank of an spp or a geom axis holds the same frame: the loss
    counts once, so the gradient is the single-device one, not the axis
    size times it."""
    got = torch.load(world / f"once_{_key(shape, kind)}.pt")
    loss, grads = _single(kind, got)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    total = torch.linalg.vector_norm(torch.cat([g.reshape(-1)
                                                for g in got["grads"]]))
    ref = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads]))
    assert float(total / ref) == pytest.approx(1.0, abs=1e-5)
    _norm_rel_ok(got["grads"], grads)


def test_mesh_shape_errors(world, capsys):
    """A shape needing more or fewer ranks than the world raises with the
    world size in its message; so does one without a world, and the CLI's
    --mesh 2,1,1 without a world exits non-zero saying so."""
    errors = json.loads((world / "errors.json").read_text())
    assert "needs 4 ranks" in errors["2x2x1"], errors
    assert "needs 16 ranks" in errors["4x2x2"], errors
    assert all("world size is 8" in e for e in errors.values()), errors
    with pytest.raises(ValueError, match="world size is 1"):
        M.make_render_mesh((2, 1, 1), device="cpu")
    assert M.make_render_mesh(device="cpu").shape == (1, 1, 1)
    from raytracer_weekend_tpu_torch.utils import cli

    args = ["two_spheres", "-w", "8", "-s", "1", "-d", "2", "--cpu",
            "--mesh", "2,1,1", "-o", "unused"]
    assert cli.main(args) == 2
    assert "world size is 1" in capsys.readouterr().err


_MULTIHOST = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
from raytracer_weekend_tpu_torch.parallel.multihost import (
    init_multihost, render_multihost)
from test_torch_parallel import scene_of
init_multihost(f"127.0.0.1:{sys.argv[2]}", 2, int(sys.argv[1]),
               device="cpu")
scene, static, cfg, cam = scene_of("auto")
np.save(sys.argv[3], render_multihost(scene, static, cfg, cam))
print("WORKER_OK", sys.argv[1])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost(tmp_path, singles):
    """Two processes through init_multihost on 127.0.0.1 (a TCP store, as
    tests/test_multihost.py's coordinator): render_multihost gives both the
    same frame, within 2e-5 of the single-device render."""
    port = _free_port()
    outs = [tmp_path / f"img{i}.npy" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST, str(i), str(port), str(outs[i]),
         str(ROOT / "tests")], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(2)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log.decode(errors="replace"))
    assert all("WORKER_OK" in log for log in logs), logs[-1][-3000:]
    img0, img1 = np.load(outs[0]), np.load(outs[1])
    np.testing.assert_array_equal(img0, img1)
    np.testing.assert_allclose(img0, singles["auto"][0], rtol=2e-5,
                               atol=2e-5)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
