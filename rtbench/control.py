"""The control of a cell's check, read at the cell's own size: the plain
reference put in the program's place, computed in bfloat16 (the nearest
precision below the configurations' float32). The benchmark's runs never
run this; its readings set the upper end of each limit (PERF.md).

    python3 -m rtbench.control --workload <name> --seeds 1 2 3

prints one JSON line a seed: each number the cell's check compares, as the
control reads it against the float32 reference.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from rtbench import common
from rtbench.reference import compare
from rtbench.reference import render as R
from rtbench.reference import scenes


def render_readings(cell: common.Cell, seed: int, device: str,
                    passes: int = 3) -> dict:
    """pass_rel_l1 of the bfloat16 reference against the float32 one, over
    `passes` passes' sampled pixels, as a run draws them."""
    import torch

    conf, traf = cell.config, cell.traffic
    W, H, D = conf["width"], conf["height"], conf["max_depth"]
    spp = int(traf["spp_per_pass"])
    desc = scenes.make_scene(conf)
    R.tf32_off()
    rng = np.random.default_rng(common.derive(seed, common.CHECK))
    n_pix = min(int(traf["check_pixels"]), W * H)
    worst = 0.0
    for k in range(passes):
        pix = torch.from_numpy(np.sort(rng.choice(W * H, n_pix,
                                                  replace=False))).to(device)
        s = common.derive(seed, common.PASS, k)
        ref, low = (R.render_pixels(
            R.Tables.build(desc, device, dt), R.camera_frame(
                desc.camera, device, dt), W, H, spp, D, pix, s,
            log10=conf["log10_volume"]).cpu()
            for dt in (torch.float32, torch.bfloat16))
        worst = max(worst, compare.rel_l1(low, ref))
    return {"control": {"pass_rel_l1": worst}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = common.find_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **render_readings(cell, seed, "cuda")}),
              flush=True)


if __name__ == "__main__":
    main()
