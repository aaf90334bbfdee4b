"""Two checkouts of the port on one card: the fused forward kernel's outputs
compared bit for bit, and its times in turns.

    python raytracer_weekend_tpu_torch/utils/ab_render.py --other DIR \
        [--out build/ab_render.json]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive` into a git-ignored directory).
Each checkout runs in its own process, with its own package on
PYTHONPATH and its own kernel build, in the order other, this, this,
other; each builds and saves into the git-ignored build/ of its
checkout and of this one. Each process renders, at 400x225, 16 spp, depth 8, render seed 0,
cornell_box, wavefront_cow_obj, textured_monument and book2_final_scene
(the planar loop, K3), jumpy_balls (spheres only, K1) and
smokey_cornell_box (media, K5) through `render_fused` (radiance and
segments; the winner codes of `emit_paths=True` too), and bench.py's
book2_criterion (40x22, 100 spp, depth 50, seeds 1337) and jumpy_balls at
400x225, 4 spp, depth 20 through the single pass and the depth-phased
render; each render is timed (CUDA events, median of 5). The first
process of each checkout saves its outputs, and the script reports for
each output whether the two checkouts agree bit for bit, and each time by
checkout. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

FULL = dict(width=400, height=225, samples_per_pixel=16, max_depth=8)
SCENES = ("cornell_box", "wavefront_cow_obj", "textured_monument",
          "book2_final_scene", "jumpy_balls", "smokey_cornell_box")
EMIT = ("cornell_box", "wavefront_cow_obj", "textured_monument",
        "book2_final_scene")
CRITERION = dict(width=40, height=22, samples_per_pixel=100, max_depth=50,
                 seed=1337)
JUMPY_DEEP = dict(width=400, height=225, samples_per_pixel=4, max_depth=20)


def _cuda_ms(fn, reps=5):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def run_one(out_dir: pathlib.Path, save: bool) -> dict:
    """Render and time everything with the package on sys.path; save the
    outputs under out_dir when `save`. -> {render: ms}."""
    import torch

    from raytracer_weekend_tpu_torch.config import RenderConfig
    from raytracer_weekend_tpu_torch.models import scenes
    from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
    from raytracer_weekend_tpu_torch.scene.builder import build_scene

    if not torch.cuda.is_available():
        raise RuntimeError("ab_render needs a CUDA device")
    dev = torch.device("cuda", 0)
    times, outs = {}, {}
    for name in SCENES:
        cfg = RenderConfig(**FULL)
        scene, static, cams = scenes.generate_scene(name, cfg.aspect_ratio,
                                                    device=dev)
        cam = cams[0].to(dev)

        def fwd(emit=False):
            return mk.render_fused(scene, cfg, cam, 0, cfg.n_rays, cfg.seed,
                                   static=static, emit_paths=emit,
                                   deep=False)

        outs[name] = fwd()
        if name in EMIT:
            outs[f"{name} codes"] = fwd(True)
        times[name] = _cuda_ms(fwd)
    for name, size in (("book2_criterion", CRITERION),
                       ("jumpy_balls_d20", JUMPY_DEEP)):
        cfg = RenderConfig(**size)
        if name == "book2_criterion":
            objs, cams, bg = scenes.book2_final_scene(cfg.aspect_ratio,
                                                      seed=cfg.seed)
            scene, static = build_scene(objs, background=bg, seed=cfg.seed)
            scene = scene.to(dev)
        else:
            scene, static, cams = scenes.generate_scene(
                "jumpy_balls", cfg.aspect_ratio, device=dev)
        cam = cams[0].to(dev)
        for route, deep in (("single", False), ("deep", True)):
            def fwd():
                return mk.render_fused(scene, cfg, cam, 0, cfg.n_rays,
                                       cfg.seed, static=static, deep=deep)

            outs[f"{name} {route}"] = fwd()
            times[f"{name} {route}"] = _cuda_ms(fwd)
    torch.cuda.synchronize()
    if save:
        torch.save({k: [t.cpu() for t in v] for k, v in outs.items()},
                   out_dir / "outputs.pt")
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default="build/ab_render.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--save", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:  # one checkout's process
        out_dir = pathlib.Path(args.child)
        out_dir.mkdir(parents=True, exist_ok=True)
        times = run_one(out_dir, args.save)
        (out_dir / f"times{'-saved' if args.save else ''}.json").write_text(
            json.dumps(times))
        return

    import torch

    this = pathlib.Path(__file__).resolve().parents[2]
    other = pathlib.Path(args.other).resolve()
    out = pathlib.Path(args.out).resolve()
    work = this / "build" / "ab_render"   # git-ignored; outputs are large
    runs = {}
    for who, root, save in (("other", other, True), ("this", this, True),
                            ("this", this, False), ("other", other, False)):
        env = dict(os.environ, PYTHONPATH=str(root))
        child = work / who
        subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                        "--other", str(other), "--child", str(child)]
                       + (["--save"] if save else []),
                       cwd=root, env=env, check=True)
        name = "times-saved.json" if save else "times.json"
        runs.setdefault(who, []).append(json.loads((child / name).read_text()))
    a = torch.load(work / "other" / "outputs.pt")
    b = torch.load(work / "this" / "outputs.pt")
    equal = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
             for k in a}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    report = dict(card=smi, other=str(other), bitwise_equal=equal,
                  ms={who: {k: [r[k] for r in rs] for k in rs[0]}
                      for who, rs in runs.items()})
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    if not all(equal.values()):
        raise SystemExit(f"outputs differ: "
                         f"{[k for k, v in equal.items() if not v]}")


if __name__ == "__main__":
    main()
