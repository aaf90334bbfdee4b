"""Tone mapping and PNG output (the JAX package's utils/image.py, numpy only).

Reproduces the reference's writeback exactly (console_app/src/main.rs:78-87):
divide the accumulated color sum by spp, gamma-correct with sqrt (gamma 2.0),
clamp to [0, 0.999], scale by 255.999, truncate to u8.
"""

from __future__ import annotations

import numpy as np


def tone_map(color_sum: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """(H,W,3) accumulated color sums -> (H,W,3) uint8."""
    c = np.asarray(color_sum, np.float32) / float(samples_per_pixel)
    c = np.sqrt(np.maximum(c, 0.0))
    c = np.clip(c, 0.0, 0.999)
    return (255.999 * c).astype(np.uint8)


def save_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an (H,W,3) uint8 image as an 8-bit RGB PNG.

    Encoded with the standard library (zlib), so the port needs no imaging
    package on the machine with the card. Write-then-rename so a viewer that
    reloads the file never reads half of it.
    """
    import os
    import struct
    import zlib

    img = np.ascontiguousarray(np.asarray(rgb_u8, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H,W,3) uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1).tobytes()   # filter byte 0 on every row

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)
