"""The port's differentiable render and fit step against the benchmark's plain
reference (`rtbench/reference/fit.py`: torch autograd through the plain
path tracer, which imports nothing of the port).

At 32x18, 2 spp, depth 6, on seeded random texels and colors:
`fused_diff.render_fused_diff`'s plain CPU route and one
`InverseRenderer` step (the step-wise `start`/`step`) give the reference's
loss, gradient over every float leaf and Adam change, on `earth.json`'s
scene (earth over a checker ground: the general deferred combine, not the
single-hit one) and on book 1's jumpy scene. The new spans and counters
of the fit path appear when traced; a `gpu` case holds the kernels'
route (K6a-emit, the combine, K7) against the plain one on a card.

Tolerances: both sides trace the same paths from the same random numbers
in float32, so only lanes whose rounding flips a decision (a hit, a
reflect-or-refract draw) differ, each by its whole contribution; at 1,152
lanes one such lane moves a gradient by ~0.1-0.3%, hence 1e-2 on the
gradients and Adam's change and 1e-3 on the loss.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_weekend_tpu_torch import fused_diff, train
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.scene.data import SceneData
from raytracer_weekend_tpu_torch.utils import metrics
from rtbench import common, port
from rtbench.drivers import fit_steps as FS
from rtbench.reference import fit as F
from rtbench.reference import render as R
from rtbench.reference import scenes

W, H, SPP, D, SEED = 32, 18, 2, 6, 11
CFG = RenderConfig(width=W, height=H, samples_per_pixel=SPP, max_depth=D,
                   seed=SEED)


def _desc(config):
    conf = common.load_json(common.ROOT / "configs" / f"{config}.json")
    conf.update(width=W, height=H)
    desc = scenes.make_scene(conf)
    rng = np.random.default_rng(5)
    for name, im in desc.images.items():
        desc.images[name] = rng.uniform(0.0, 1.0, im.shape).astype(np.float32)
    for t in desc.textures:
        t["color1"] = tuple(rng.uniform(0.05, 0.95, 3))
        t["color2"] = tuple(rng.uniform(0.05, 0.95, 3))
    return desc


@pytest.fixture(scope="module", params=["earth", "rtw1_final"])
def case(request):
    desc = _desc(request.param)
    scene, static, cam = port.build(desc, "cpu")
    links = FS.leaf_links(scene, desc)
    target = torch.from_numpy(np.random.default_rng(6).uniform(
        0.0, 1.0, (H, W, 3)).astype(np.float32))
    T = R.Tables.build(desc, "cpu")
    loss, grads = F.loss_and_grad(T, R.camera_frame(desc.camera, "cpu",
                                                    torch.float32),
                                  W, H, SPP, D, target, SEED)
    params = [t for t in scene.leaves() if t.is_floating_point()]
    return dict(name=request.param, scene=scene, static=static, cam=cam,
                target=target, loss=loss,
                grads=FS.program_layout(grads, params, links))


def test_earth_takes_the_general_combine():
    _, static, _ = port.build(_desc("earth"), "cpu")
    assert static.has_image and not static.defer_single_hit
    assert static.n_spheres == 2 and static.fused_simple


def _fused_loss_and_grad(c, cfg=CFG):
    leaves = [t.detach().clone() for t in c["scene"].leaves()]
    params = [t.requires_grad_() for t in leaves if t.is_floating_point()]
    scene = SceneData.from_leaves(leaves, c["scene"].trees)
    rad = fused_diff.render_fused_diff(scene, c["static"], cfg, c["cam"], 0,
                                       cfg.n_rays, cfg.seed)
    img = rad.reshape(cfg.n_pixels, cfg.samples_per_pixel, 3).sum(1)
    img = img.reshape(cfg.height, cfg.width, 3) / cfg.samples_per_pixel
    loss = torch.mean((img - c["target"].to(img.device)) ** 2)
    loss.backward()
    return float(loss.detach()), [p.grad if p.grad is not None
                                  else torch.zeros_like(p) for p in params]


def test_fused_diff_plain_route_matches_reference(case):
    loss, grads = _fused_loss_and_grad(case)
    assert abs(loss - case["loss"]) / case["loss"] < 1e-3
    assert FS.rel_l1(grads, case["grads"]) < 1e-2
    # The texels (earth) or the colors (jumpy) carry the gradient.
    assert sum(float(g.abs().sum()) for g in case["grads"]) > 0


def test_one_fit_step_matches_reference(case):
    ir = train.InverseRenderer(case["static"], CFG, case["cam"],
                               case["target"])
    run = ir.start(case["scene"])
    before = [p.detach().clone() for p in run.params]
    loss = run.step()
    assert abs(loss - case["loss"]) / case["loss"] < 1e-3
    g = [m / (1.0 - F.BETAS[0]) for m in FS.snapshot(run)[1]]
    assert FS.rel_l1(g, case["grads"]) < 1e-2
    moved = [(p.detach().double() - q.double())
             for p, q in zip(run.params, before)]
    want = [F.adam_step(torch.zeros_like(gr), torch.zeros_like(gr), 0, gr,
                        ir.learning_rate) for gr in case["grads"]]
    assert FS.rel_l1(moved, want) < 1e-2
    # The scene passed in is untouched.
    assert all(torch.equal(a, b) for a, b in zip(
        (t for t in case["scene"].leaves() if t.is_floating_point()), before))


def test_fit_is_the_step_loop():
    """`fit` is `start` and `steps` calls of `step`: the same losses and
    parameters, and a step's `seed` draws other samples."""
    c = dict(zip(("scene", "static", "cam"), port.build(_desc("earth"),
                                                        "cpu")))
    target = torch.full((H, W, 3), 0.4)
    ir = train.InverseRenderer(c["static"], CFG, c["cam"], target)
    fitted, hist = ir.fit(c["scene"], steps=2)
    run = ir.start(c["scene"])
    assert [run.step(), run.step()] == hist
    for a, b in zip(fitted.leaves(), run.scene.leaves()):
        assert torch.equal(a, b)
    other = ir.start(c["scene"])
    assert other.step(seed=SEED + 1) != hist[0]


def test_fit_spans_and_counters_are_traced():
    """Under the profiler a fit step and the fused differentiable render
    leave their spans; under `tracing()` the counters count the lanes
    differentiated and the records' slots and live records."""
    from torch.profiler import ProfilerActivity, profile

    scene, static, cam = port.build(_desc("earth"), "cpu")
    c = dict(scene=scene, static=static, cam=cam,
             target=torch.full((H, W, 3), 0.4))
    ir = train.InverseRenderer(static, CFG, cam, c["target"])
    run = ir.start(scene)
    metrics.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fused_loss_and_grad(c)
            run.step()
        names = {e.name for e in prof.events()}
        for span in ("rtw.diff.forward", "rtw.diff.backward",
                     "rtw.diff.combine", "rtw.fit.step", "rtw.fit.adam"):
            assert span in names, span
        metrics.reset_counters()
        with metrics.tracing():
            _fused_loss_and_grad(c)
        got = metrics.counters()
        assert got["diff_lanes"] == CFG.n_rays
        assert got["record_slots"] == CFG.n_rays * D
        assert 0 < got["live_records"] < got["record_slots"]
    finally:
        metrics.reset_counters()
    metrics.reset_counters()
    _fused_loss_and_grad(c)                 # tracing off: nothing counted
    assert metrics.counters() == {}


@pytest.mark.gpu
def test_kernels_route_matches_plain_route():
    """On a card: the kernels' route (K6a-emit, the combine, K2 with K7)
    gives the plain route's loss and gradients on earth's scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    cfg = dataclasses.replace(CFG, width=64, height=36, samples_per_pixel=4,
                              max_depth=50)
    desc = _desc("earth")
    scene, static, cam = port.build(desc, "cpu")
    target = torch.full((36, 64, 3), 0.4)
    c = dict(scene=scene, static=static, cam=cam, target=target)
    loss, grads = _fused_loss_and_grad(c, cfg)
    gpu = dict(scene=scene.to("cuda"), static=static, cam=cam.to("cuda"),
               target=target.cuda())
    k_loss, k_grads = _fused_loss_and_grad(gpu, cfg)
    assert abs(k_loss - loss) / loss < 1e-3
    assert FS.rel_l1([g.cpu() for g in k_grads],
                     [g.double() for g in grads]) < 1e-2
