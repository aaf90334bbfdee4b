"""The frozen count of one fit step's work, forward and backward.

Like `roofline.render_pass`, it reads the same work whatever implements
the kernels: the configuration's frozen `segments_per_sample` times fixed
numbers, and bytes that must cross the card's memory once.

- Forward (the emit kernels, K1-emit or K6a-emit): a render pass
  (`roofline.render_pass`), plus each traced segment's winner code and, in
  a scene with image texels, its deferred record, written once. Counted by
  segment, not by the lanes x depth slots a kernel may lay out.
- Backward (the replay kernels, K2 with K7): each segment recomputed and
  differentiated, `OPS_PER_SEGMENT_BWD` operations, plus every float leaf's
  gradient written once.

Both are lower bounds, so a kernel's share of its roofline stays under
100%.
"""

from __future__ import annotations

from rtbench.reference import roofline

# A segment's winner code (int32), and its deferred record: the
# contribution (3 float32), the hit point (3 float32) and the code (int32).
CODE_BYTES = 4
RECORD_BYTES = 28

# The replay backward's operations a segment: the segment recomputed
# (roofline.OPS_PER_SEGMENT) and its adjoint, counted as as many again.
OPS_PER_SEGMENT_BWD = 2 * roofline.OPS_PER_SEGMENT

# Float leaves of the scene a fit differentiates, per row: a sphere (two
# centers, two times, a radius), a rect (four bounds, k), a triangle
# (three vertices, three normals, three uvs), a medium (center, radius, box
# corners, rotation, offset, density), a material (fuzz, ior), a texture
# (two colors, scale); and a scene's Perlin gradients and background.
LEAF_FLOATS = {"spheres": 9, "rects": 5, "triangles": 24, "volumes": 15,
               "materials": 2, "textures": 7}
SCENE_FLOATS = 256 * 3 + 3
FLOAT_BYTES = 4


def samples(config: dict, spp: int) -> int:
    return config["width"] * config["height"] * spp


def float_leaves(config: dict) -> int:
    """Float elements of every leaf the fit updates."""
    counts = config["primitives"]
    return (sum(LEAF_FLOATS[k] * counts.get(k, 0) for k in LEAF_FLOATS)
            + 3 * config.get("texels", 0) + SCENE_FLOATS)


def forward(config: dict, spp: int) -> tuple[float, float]:
    """(operations, bytes) of a step's forward render with codes."""
    ops, nbytes = roofline.render_pass(config, spp)
    per_segment = CODE_BYTES + (RECORD_BYTES if config.get("texels") else 0)
    segments = samples(config, spp) * config["segments_per_sample"]
    return ops, nbytes + segments * per_segment


def backward(config: dict, spp: int) -> tuple[float, float]:
    """(operations, bytes) of a step's replay backward."""
    segments = samples(config, spp) * config["segments_per_sample"]
    return (float(segments * OPS_PER_SEGMENT_BWD),
            float(float_leaves(config) * FLOAT_BYTES))


def step(config: dict, spp: int) -> dict:
    return {"forward": forward(config, spp), "backward": backward(config, spp)}
