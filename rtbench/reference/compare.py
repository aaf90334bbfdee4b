"""The numbers that decide `correct`, each compared with its limit.

Frames: the program's per-pixel sums of a checked pass against the plain
reference's over the sampled pixels, as `rel_l1 = sum |prog - ref| /
sum |ref|` over pixels and channels. Both trace the same paths from the
same random numbers, so only the lanes where float rounding flips a
decision differ; a pass rendered from other numbers, with samples left out
or at a lower precision differs on most lanes.
"""

from __future__ import annotations

import math

import torch


def rel_l1(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.double(), ref.double()
    if not bool(torch.isfinite(prog).all()):
        return math.inf
    return float((prog - ref).abs().sum() / ref.abs().sum().clamp_min(1e-30))

