"""Traffic `fit_steps`: inverse rendering, a closed loop of fit steps through
the program's `train.InverseRenderer` (`start(scene)`, then `step()`), one
step in flight: each step reads its loss on the host.

Parameters (the traffic file): `spp_per_pass` samples a pixel that each
step renders forward and differentiates, `learning_rate` (Adam, default
betas), `warmup_steps` steps in the set-up, `start` the perturbation of
the true scene the fit starts from (`START`), `target_spp` and
`target_seed` the target image's samples a pixel and seed, and
`check_within`: the checked step is drawn from the seed among the window's
first `check_within`.

The set-up renders the target (the true scene, by the program, once), makes
the warm-up steps and resets the parameters and Adam to the start. The
scene, the start and the target come from the configuration alone; the
run's seed draws each step's samples and the checked step.

The check: before the checked step the parameters and Adam's state are
copied; after the window the program is freed, and the plain reference
(`reference/fit.py`) computes the loss at those parameters with the step's
samples and its gradient over every float leaf. The program's gradient is
read back from Adam's first moment, g = (m_k - b1 m_{k-1}) / (1 - b1), and
its change of the parameters is compared with Adam applied to the
reference's gradient from the copied state. The driver takes scenes of
spheres (the reference's rows are matched to the program's by value).
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np

from rtbench import common, port
from rtbench.reference import fit as F
from rtbench.reference import render as R
from rtbench.reference import rates, roofline_fit, scenes


def _texels_half(desc):
    for name in desc.images:
        desc.images[name] = np.full_like(desc.images[name], 0.5)


# The starts a traffic may name: the true scene with these leaves changed.
START = {"texels_half": _texels_half}


def start_scene(desc: scenes.SceneDesc, kind: str) -> scenes.SceneDesc:
    out = copy.deepcopy(desc)
    START[kind](out)
    return out


# The program's float leaves that the reference's tables hold, by table;
# each reference table has the program leaf's name.
LINKED = (("spheres", ("c0", "c1", "t0", "t1", "radius")),
          ("materials", ("fuzz", "ior")),
          ("textures", ("color1", "color2", "scale", "images")))


def leaf_links(scene, desc: scenes.SceneDesc) -> list:
    """(float leaf index, table name, the program's rows, the reference's
    rows) for every program leaf that the reference also has; rows None
    means all. Spheres are matched by their numbers, materials and
    textures through the spheres that use them, images through their
    textures."""
    import torch

    if desc.rects or desc.triangles or desc.volumes:
        raise NotImplementedError("fit_steps matches sphere scenes only")
    names = [(t, f) for t in ("spheres", "rects", "triangles", "volumes",
                              "materials", "textures")
             for f in getattr(scene, t)._fields] + [("background", None)]
    floats = [n for n, leaf in zip(names, scene.leaves())
              if leaf.is_floating_point()]
    index = {n: k for k, n in enumerate(floats)}

    def key(c0, c1, t0, t1, r):
        return tuple(np.float32(x).item() for x in (*c0, *c1, t0, t1, r))

    s = scene.spheres.to("cpu")
    mat_tex = scene.materials.tex.cpu()
    image_id = scene.textures.image_id.cpu()
    prog = {}
    for i in range(int(s.valid.sum())):
        prog.setdefault(key(s.c0[i].tolist(), s.c1[i].tolist(),
                            float(s.t0[i]), float(s.t1[i]),
                            float(s.radius[i])), []).append(i)
    pairs = {"spheres": {}, "materials": {}, "textures": {}, "images": {}}
    names_img = sorted(desc.images)
    for j, (c0, c1, t0, t1, r, m) in enumerate(desc.spheres):
        i = prog[key(c0, c1, t0, t1, r)].pop(0)
        pairs["spheres"][i] = j
        pm = int(s.mat[i])
        if pairs["materials"].setdefault(pm, m) != m:
            raise ValueError(f"program material {pm} is two of the scene's")
        pt, rt = int(mat_tex[pm]), desc.materials[m]["tex"]
        if pairs["textures"].setdefault(pt, rt) != rt:
            raise ValueError(f"program texture {pt} is two of the scene's")
        if desc.textures[rt]["type"] == "image":
            pairs["images"][int(image_id[pt])] = names_img.index(
                desc.textures[rt]["image"])

    def rows(by):
        p, r = zip(*sorted(by.items())) if by else ((), ())
        return torch.tensor(p, dtype=torch.long), torch.tensor(
            r, dtype=torch.long)

    links = [(index[(t, f)], f,
              *rows(pairs["images" if f == "images" else t]))
             for t, fields in LINKED for f in fields]
    return links + [(index[("textures", "perlin_grad")], "perlin_grad",
                     None, None),
                    (index[("background", None)], "background", None, None)]


def _rows(t, rows):
    return t if rows is None else t[rows.to(t.device)]


def reference_tables(T: R.Tables, params: list, links: list) -> R.Tables:
    """The reference's tables holding the program's parameter values."""
    out = {}
    for i, field, prow, rrow in links:
        tab = out.get(field, getattr(T, field).clone())
        value = _rows(params[i], prow).to(tab.device, tab.dtype)
        if rrow is None:
            tab = value.reshape(tab.shape).clone()
        else:
            tab[rrow.to(tab.device)] = value
        out[field] = tab
    return T._replace(**out)


def program_layout(grads: dict, params: list, links: list) -> list:
    """The reference's gradients laid out as the program's float leaves;
    0 where the reference has no such leaf (padding rows, trees)."""
    import torch

    out = [torch.zeros_like(p, dtype=torch.float64, device="cpu")
           for p in params]
    for i, field, prow, rrow in links:
        g = _rows(grads[field], rrow).double().cpu()
        if prow is None:
            out[i] = g.reshape(out[i].shape).clone()
        else:
            out[i][prow] = g
    return out


def rel_l1(prog: list, ref: list) -> float:
    num = sum(float((a.double().cpu() - b).abs().sum())
              for a, b in zip(prog, ref))
    den = sum(float(b.abs().sum()) for b in ref)
    return num / max(den, 1e-300)


def snapshot(run):
    """The parameters and Adam's moments and step count, copied."""
    import torch

    state = run.optimizer.state
    m = [state[p]["exp_avg"].clone() if "exp_avg" in state.get(p, {})
         else torch.zeros_like(p) for p in run.params]
    v = [state[p]["exp_avg_sq"].clone() if "exp_avg_sq" in state.get(p, {})
         else torch.zeros_like(p) for p in run.params]
    steps = [int(state[p]["step"]) if "step" in state.get(p, {}) else 0
             for p in run.params]
    return [p.detach().clone() for p in run.params], m, v, steps


def _plant(run, faults: dict, ir, spp: int):
    """A fault under the timed path: `frozen` (Adam's step leaves the
    parameters as they were), `half` (half the samples a step), `grad`
    (each gradient's rows in the wrong order before Adam's step)."""
    if "half" in faults:
        run.renderer = dataclasses.replace(ir, cfg=dataclasses.replace(
            ir.cfg, samples_per_pixel=max(spp // 2, 1)))
    if "frozen" in faults:
        run.optimizer.step = lambda *a, **k: None
    if "grad" in faults:
        step = run.optimizer.step

        def flipped(*a, **k):
            for p in run.params:
                if p.grad is not None:
                    dims = [d for d in range(p.dim()) if p.shape[d] > 1]
                    if dims:
                        p.grad = p.grad.flip(dims[0])
            return step(*a, **k)

        run.optimizer.step = flipped


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", faults: dict | None = None):
    import torch

    from raytracer_weekend_tpu_torch import integrator
    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    if not hasattr(InverseRenderer, "start"):
        raise NotImplementedError("the program's InverseRenderer has no "
                                  "step-wise fit (start, step)")
    faults = faults or {}
    conf, traf = cell.config, cell.traffic
    W, H, D = conf["width"], conf["height"], conf["max_depth"]
    spp = int(traf["spp_per_pass"])
    lr = float(traf["learning_rate"])
    desc = scenes.make_scene(conf)
    start = start_scene(desc, traf["start"])
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_depth=D, seed=0,
                       ray_batch=int(conf.get("ray_batch", 0)),
                       use_log10_volume_sampling=conf["log10_volume"])

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    # The target: the true scene, rendered by the program once, in chunks
    # of at most one step's lanes.
    true, static, cam = port.build(desc, device)
    t_spp = int(traf["target_spp"])
    t_cfg = dataclasses.replace(cfg, samples_per_pixel=t_spp,
                                seed=int(traf["target_seed"]),
                                ray_batch=W * H * min(spp, t_spp))
    with torch.no_grad():
        target = integrator.render_image(true, static, t_cfg, cam) / t_spp
    del true
    scene0, static0, cam = port.build(start, device)
    links = leaf_links(scene0, start)
    ir = InverseRenderer(static0, cfg, cam, target, learning_rate=lr)
    warm = ir.start(scene0)
    for k in range(int(traf["warmup_steps"])):
        warm.step(seed=common.derive(seed, common.WARM, k))
    del warm
    fit = ir.start(scene0)               # the parameters and Adam reset
    _plant(fit, faults, ir, spp)
    sync()
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(common.derive(seed, common.CHECK))
    k_check = int(rng.integers(int(traf["check_within"])))
    window = min(seconds, float(traf.get("trace_seconds", seconds))) \
        if trace else seconds
    prof = None
    if trace:
        from rtbench.trace import WINDOW_SPAN, Profiler

        prof = Profiler().__enter__()
        span = torch.profiler.record_function(WINDOW_SPAN).__enter__()
    losses, snap, after = [], None, None
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < window or i <= k_check:
        if i == k_check:
            snap = snapshot(fit)
        losses.append(fit.step(seed=common.derive(seed, common.PASS, i)))
        if i == k_check:
            after = snapshot(fit)
        i += 1
    sync()
    t1 = time.perf_counter()
    if trace:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    steps, window_s = i, t1 - t0
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    # The program's gradient at step k, from Adam's first moment.
    p0, m0, v0, n_steps = snap
    p1, m1 = after[0], after[1]
    b1 = F.BETAS[0]
    g_prog = [((a.double() - b1 * b.double()) / (1.0 - b1)).cpu()
              for a, b in zip(m1, m0)]
    moved = [(a.double() - b.double()).cpu() for a, b in zip(p1, p0)]
    nonfinite = (sum(int((~torch.isfinite(x)).sum()) for x in g_prog + p1)
                 + int(not np.isfinite(losses[k_check])))
    params, m0, v0 = ([x.cpu() for x in xs] for xs in (p0, m0, v0))
    failed = sum(1 for x in losses if not np.isfinite(x))
    target = target.cpu()
    del fit, ir, scene0, snap, after, p0, p1, m1
    if device != "cpu":
        torch.cuda.empty_cache()

    # The check: the plain reference at the copied parameters.
    t_ref = time.perf_counter()
    R.tf32_off()
    T = reference_tables(R.Tables.build(start, device), params, links)
    cam_r = R.camera_frame(start.camera, device, torch.float32)
    loss_ref, grads = F.loss_and_grad(
        T, cam_r, W, H, spp, D, target,
        common.derive(seed, common.PASS, k_check),
        log10=conf["log10_volume"])
    g_ref = program_layout(grads, params, links)
    moved_ref = [F.adam_step(m, v, t, g, lr)
                 for m, v, t, g in zip(m0, v0, n_steps, g_ref)]
    loss_rel = abs(losses[k_check] - loss_ref) / max(abs(loss_ref), 1e-300)
    limits = cell.limits
    checks = [("loss_rel", loss_rel, limits["loss_rel"]),
              ("grad_rel_l1", rel_l1(g_prog, g_ref), limits["grad_rel_l1"]),
              ("step_rel_l1", rel_l1(moved, moved_ref),
               limits["step_rel_l1"]),
              ("nonfinite", nonfinite, 0)]
    common.note(f"setup_s {setup_s:.3f}, window {window_s:.3f} s, "
                f"{steps} steps, checked step {k_check}, reference "
                f"{time.perf_counter() - t_ref:.3f} s")
    return dict(setup_s=setup_s, window_s=window_s, units=steps,
                samples_per_s=rates.samples_per_s(W, H, spp, steps,
                                                  window_s),
                attempted=steps, failed=failed, peak=peak, checks=checks,
                count=1, trace=prof.data if prof else None,
                work=roofline_fit.step(conf, spp))
