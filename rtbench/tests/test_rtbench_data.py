"""The benchmark's data: the manifest against its contract, every file it
names, a cell added as data alone, seeds, and the frozen roofline count."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from rtbench import common
from rtbench.reference import roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.manifest()


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_parses(name):
    """Its configuration, traffic, limits, driver and metric readers load,
    and it reports setup_s, another end-to-end metric and a per-layer one."""
    cell = common.find_cell(name)
    assert common.driver(cell.kind).run
    for m in cell.per_layer:
        assert callable(common.reader(m["name"]).read)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(isinstance(v, (int, float)) for v in cell.limits.values())
    conf = cell.config
    for key in ("scene", "scene_seed", "width", "height", "max_depth",
                "source",
                "assumed", "reduced", "segments_per_sample", "primitives"):
        assert key in conf, key


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {p.stem for p in (common.ROOT / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_a_cell_added_as_data_alone_is_found(tmp_path):
    """A new traffic file, limits file and manifest entry, and no edit of
    an existing file: the cell is found and reports its metrics."""
    root = tmp_path / "rtbench"
    shutil.copytree(common.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "traffic" / "pass4.json").write_text(json.dumps(
        {**common.load_json(root / "traffic" / "pass16.json"),
         "spp_per_pass": 4}))
    (root / "limits" / "rtw1_final.pass4.json").write_text(
        json.dumps({"pass_rel_l1": 0.01}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rtw1_final.pass4",
                               "config": "rtw1_final", "traffic": "pass4",
                               "chips": 1, "why": "1-spp previews"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rtw1_final.pass16" in m.get("workloads", []):
            m["workloads"].append("rtw1_final.pass4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = common.find_cell("rtw1_final.pass4", root=root)
    assert cell.traffic["spp_per_pass"] == 4
    assert {m["name"] for m in cell.end_to_end} >= {"samples_per_s",
                                                     "setup_s"}
    assert len(cell.per_layer) >= 1


CORNELL = {
    "background": [0.0, 0.0, 0.0],
    "textures": [{"type": "solid", "color1": c} for c in
                 ([0.65, 0.05, 0.05], [0.73, 0.73, 0.73],
                  [0.12, 0.45, 0.15], [15.0, 15.0, 15.0])],
    "materials": [{"type": "lambertian", "tex": 0},
                  {"type": "lambertian", "tex": 1},
                  {"type": "lambertian", "tex": 2},
                  {"type": "light", "tex": 3}],
    "rects": [[0, 0, 555, 0, 555, 555, 2], [0, 0, 555, 0, 555, 0, 0],
              [1, 213, 343, 227, 332, 554, 3], [1, 0, 555, 0, 555, 0, 1],
              [1, 0, 555, 0, 555, 555, 1], [2, 0, 555, 0, 555, 555, 1]],
    "cuboids": [[[0, 0, 0], [165, 330, 165], 1, 15.0, [265, 0, 295]],
                [[0, 0, 0], [165, 165, 165], 1, -18.0, [130, 0, 65]]],
    "camera": {"look_from": [278, 278, -800], "look_at": [278, 278, 0],
               "vfov": 40.0}}


def test_a_scene_added_as_data_alone(tmp_path):
    """A configuration's `scene_file` (the book's Cornell box, its boxes
    rotated): the program's builder gets the tables of the program's own
    catalog scene, and the reference renders what the program renders."""
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes as catalog
    from raytracer_weekend_tpu_torch.scene import builder
    from raytracer_weekend_tpu_torch.scene.data import without_trees

    from rtbench import port
    from rtbench.reference import render as R
    from rtbench.reference import scenes

    path = tmp_path / "cornell.json"
    path.write_text(json.dumps(CORNELL))
    conf = {"width": 20, "height": 20, "scene_file": str(path),
            "scene_seed": 7}
    desc = scenes.make_scene(conf)
    data, static, cam = port.build(desc, "cpu")
    want, _ = builder.build_scene(*catalog.cornell_box(1.0)[0::2], seed=7)
    for table in ("rects", "triangles"):
        for a, b in zip(getattr(data, table), getattr(want, table)):
            assert torch.equal(a, b)
    cfg = RenderConfig(width=20, height=20, samples_per_pixel=2,
                       max_depth=8, seed=3)
    img = integrator.render_image(*without_trees(data, static), cfg, cam)
    ref = R.render_pixels(R.Tables.build(desc, "cpu"),
                          R.camera_frame(desc.camera, "cpu", torch.float32),
                          20, 20, 2, 8, torch.arange(400), 3)
    assert float((img.reshape(-1, 3) - ref).abs().sum()
                 / ref.abs().sum()) < 1e-3


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_inputs_are_deterministic_from_the_seed(name):
    """The scene is the configuration's, whatever the run's seed; each
    pass's seed follows from the run's seed and the pass's index alone,
    also for seeds past 32 bits."""
    from rtbench.reference import scenes

    cell = common.find_cell(name)
    a, b = (scenes.make_scene(cell.config) for _ in range(2))
    assert a.spheres == b.spheres and a.rects == b.rects
    assert a.materials == b.materials and a.volumes == b.volumes
    assert a.camera == b.camera and a.perlin_seed == b.perlin_seed
    assert "scene_seed" not in cell.traffic
    big = 2 ** 40 + 12345
    assert common.derive(big, common.PASS, 7) == \
        common.derive(big, common.PASS, 7)
    assert common.derive(big, common.PASS, 7) != \
        common.derive(big, common.PASS, 8)
    assert common.derive(big, common.PASS, 7) != \
        common.derive(big + 1, common.PASS, 7)
    assert 0 <= common.derive(2 ** 63 + 5, 1) < 2 ** 31


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_roofline_count_depends_only_on_the_cells_data(name):
    """The count is segments x a fixed constant plus bytes read and written
    once, from the cell's data alone: the same numbers again, proportional
    to the samples."""
    cell = common.find_cell(name)
    conf, spp = cell.config, cell.traffic["spp_per_pass"]
    ops, nbytes = roofline.render_pass(conf, spp)
    assert roofline.render_pass(conf, spp) == (ops, nbytes)
    assert roofline.render_pass(conf, 2 * spp)[0] == 2 * ops
    samples = conf["width"] * conf["height"] * spp
    assert ops == (samples * conf["segments_per_sample"]
                   * roofline.OPS_PER_SEGMENT)
    assert nbytes >= roofline.scene_bytes(conf)
    bound, by = roofline.bound_seconds(ops, nbytes)
    assert bound > 0 and by in ("flops", "bytes")
