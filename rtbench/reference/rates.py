"""The rate arithmetic of the end-to-end metrics, frozen with the yardstick
(after the program's `utils.metrics.RenderStats`, which divides one
frame's work by one frame's time; here all the window's work over all its
time).

Work is counted from the inputs (pixels x samples of every pass that
completed), never from the program's own counts.
"""

from __future__ import annotations


def samples_per_s(width: int, height: int, spp: int, passes: int,
                  window_s: float) -> float:
    """Pixel samples of every completed pass over the window's seconds."""
    return width * height * spp * passes / window_s

