"""The control of a fit cell's check, read at the cell's own size: the plain
reference put in the program's place and computed in bfloat16 (the nearest
precision below the configurations' float32). The benchmark's runs never
run this; its readings set the upper end of each limit (PERF.md).

    python3 -m rtbench.control_fit --workload earth.fit16 --seeds 1 2 3

prints one JSON line a seed: each number the fit cell's check compares,
as the control reads it against the float32 reference: the loss and the
gradient over every float table at the traffic's start, with the samples
of a window's first step, and Adam's first step from them.
"""

from __future__ import annotations

import argparse
import json

from rtbench import common
from rtbench.drivers.fit_steps import start_scene
from rtbench.reference import fit as F
from rtbench.reference import render as R
from rtbench.reference import scenes


def fit_readings(cell: common.Cell, seed: int, device: str) -> dict:
    """loss_rel, grad_rel_l1 and step_rel_l1 of the bfloat16 reference
    against the float32 one; the target is the float32 reference's frame
    of the true scene at the traffic's `target_spp` and `target_seed`."""
    import torch

    conf, traf = cell.config, cell.traffic
    W, H, D = conf["width"], conf["height"], conf["max_depth"]
    spp, log10 = int(traf["spp_per_pass"]), conf["log10_volume"]
    desc = scenes.make_scene(conf)
    start = start_scene(desc, traf["start"])
    R.tf32_off()
    f32 = torch.float32
    target = F.frame(R.Tables.build(desc, device),
                     R.camera_frame(desc.camera, device, f32), W, H,
                     int(traf["target_spp"]), D, int(traf["target_seed"]),
                     log10=log10)
    s = common.derive(seed, common.PASS, 0)
    (loss, grads), (low, low_grads) = (F.loss_and_grad(
        R.Tables.build(start, device, dt),
        R.camera_frame(start.camera, device, dt), W, H, spp, D, target, s,
        log10=log10) for dt in (f32, torch.bfloat16))
    lr = float(traf["learning_rate"])

    def moved(g):
        z = torch.zeros_like(g, dtype=torch.float64)
        return F.adam_step(z, z, 0, g, lr)

    def rel(a, b):
        num = sum(float((a[f].double() - b[f].double()).abs().sum())
                  for f in b)
        return num / max(sum(float(b[f].double().abs().sum()) for f in b),
                         1e-300)

    return {"control": {
        "loss_rel": abs(low - loss) / loss,
        "grad_rel_l1": rel(low_grads, grads),
        "step_rel_l1": rel({f: moved(g) for f, g in low_grads.items()},
                           {f: moved(g) for f, g in grads.items()})}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = common.find_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **fit_readings(cell, seed, "cuda")}), flush=True)


if __name__ == "__main__":
    main()
