"""The frozen count of a pass's work, and the H100's peaks.

The count reads the same work whatever implements the kernels: the
segments a sample traces (counted once per configuration by the plain
reference, `count_segments.py`, and stored in the configuration's file as
`segments_per_sample`) times a fixed number of operations a segment, and
the bytes of the scene's primitives read once and of each lane's outputs
written once. It never counts rows tested, so a kernel that finds hits
through a tree does the same counted work as a brute force, and its share
cannot read above 100%. It is a lower bound: shares are small.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operations of one segment: one primitive test (the ray-sphere quadratic,
# ~24 flops), one counter-based draw of four uniforms (PCG4D, ~40 integer
# operations) and one scatter (a unit vector, a normalize and the
# throughput product, ~36).
OPS_PER_SEGMENT = 100

# Bytes: a sphere row (two centers, two times, a radius, a material id), a
# rect row (axis, four bounds, k, material), a triangle row (three vertices,
# three normals, three uvs, a material), a medium row (center, radius,
# density, material), a material (type, texture, fuzz, ior), a texture
# (type, two colors, scale, image id); a lane's radiance (3 float32) and
# segment count written once.
BYTES = {"spheres": 40, "rects": 32, "triangles": 100, "volumes": 24,
         "materials": 16, "textures": 36}
LANE_OUT_BYTES = 16


def scene_bytes(config: dict) -> int:
    counts = config["primitives"]
    return sum(BYTES[k] * counts.get(k, 0) for k in BYTES) + \
        4 * config.get("texels", 0) * 3


def render_pass(config: dict, spp: int) -> tuple[float, float]:
    """(operations, bytes) of one pass of `spp` samples a pixel."""
    samples = config["width"] * config["height"] * spp
    ops = samples * config["segments_per_sample"] * OPS_PER_SEGMENT
    return float(ops), float(scene_bytes(config) + samples * LANE_OUT_BYTES)


def bound_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and which peak bounds it."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
