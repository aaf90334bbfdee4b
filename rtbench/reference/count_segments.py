"""Count a configuration's segments a sample with the plain reference, once,
for its file's `segments_per_sample` (the frozen roofline count), and its
primitives and texels for the count's bytes.

    python3 -m rtbench.reference.count_segments rtbench/configs/<config>.json

It traces `--lanes` lanes drawn from `--seed` uniformly over the whole
frame's samples (16 a pixel) of the configuration's scene, on the CPU by
default, and prints the counts as JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from rtbench.reference import render as R
from rtbench.reference import scenes


def count(config: dict, seed: int, lanes: int, device: str = "cpu") -> dict:
    W, H, D = config["width"], config["height"], config["max_depth"]
    desc = scenes.make_scene(config)
    T = R.Tables.build(desc, device)
    cam = R.camera_frame(desc.camera, device, torch.float32)
    spp = 16
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(np.sort(rng.choice(W * H * spp, lanes,
                                              replace=False))).to(device)
    total = 0
    with torch.no_grad():
        for s in range(0, lanes, 4096):
            _, seg = R.render_lanes(T, cam, W, H, spp, D, ids[s:s + 4096],
                                    seed, log10=config["log10_volume"])
            total += int(seg.sum())
    texels = sum(int(np.prod(im.shape[:2])) for im in desc.images.values())
    return {"segments_per_sample": total / lanes,
            "primitives": desc.counts, "texels": texels}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=16384)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    with open(args.config) as f:
        config = json.load(f)
    print(json.dumps(count(config, args.seed, args.lanes, args.device)))


if __name__ == "__main__":
    main()
