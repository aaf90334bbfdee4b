"""Live pixel-stream wire protocol (port of `parallel/stream.py`, its
single-device part).

The reference streams a postcard+COBS pixel stream: `ProgressMessage`
serialized with postcard, COBS-framed on 0x00, and reassembled by a
loss-tolerant receiver. This module speaks the same wire format (postcard
LEB128 varints and little-endian f32, COBS framing) as the JAX package's,
byte for byte:

  ImageStart { width: u32, height: u32, samples_per_pixel: u32 }   tag 0
  Pixel      { row: u32, column: u32, color: [f32; 3] }            tag 1
  ImageEnd                                                          tag 2

`stream_render` renders chunk by chunk through the staged path
(`integrator.render_chunk`) and emits one frame per finished pixel.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

IMAGE_START = 0
PIXEL = 1
IMAGE_END = 2


# ---------------------------------------------------------------------------
# postcard primitives: LEB128 varints for u32, little-endian f32
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    value = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 35:
            raise ValueError("varint too long")


# ---------------------------------------------------------------------------
# COBS framing (0x00-delimited)
# ---------------------------------------------------------------------------

def cobs_encode(data: bytes) -> bytes:
    """Consistent Overhead Byte Stuffing; no trailing delimiter."""
    out = bytearray()
    block = bytearray()
    for byte in data:
        if byte == 0:
            out.append(len(block) + 1)
            out.extend(block)
            block.clear()
        else:
            block.append(byte)
            if len(block) == 254:
                out.append(255)
                out.extend(block)
                block.clear()
    out.append(len(block) + 1)
    out.extend(block)
    return bytes(out)


def cobs_decode(frame: bytes) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(frame):
        code = frame[pos]
        if code == 0:
            raise ValueError("zero byte inside COBS frame")
        block = frame[pos + 1:pos + code]
        if len(block) != code - 1:
            raise ValueError("truncated COBS block")
        out.extend(block)
        pos += code
        if code != 0xFF and pos < len(frame):
            out.append(0)
    return bytes(out)


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ImageStart:
    width: int
    height: int
    samples_per_pixel: int


@dataclasses.dataclass
class Pixel:
    row: int
    column: int
    color: tuple  # (r, g, b) raw accumulated radiance sums


@dataclasses.dataclass
class ImageEnd:
    pass


Message = object


def encode_message(msg: Message) -> bytes:
    """postcard encoding + COBS frame + 0x00 delimiter."""
    if isinstance(msg, ImageStart):
        payload = (_varint(IMAGE_START) + _varint(msg.width)
                   + _varint(msg.height) + _varint(msg.samples_per_pixel))
    elif isinstance(msg, Pixel):
        payload = (_varint(PIXEL) + _varint(msg.row) + _varint(msg.column)
                   + struct.pack("<3f", *msg.color))
    elif isinstance(msg, ImageEnd):
        payload = _varint(IMAGE_END)
    else:
        raise TypeError(type(msg))
    return cobs_encode(payload) + b"\x00"


def decode_payload(payload: bytes) -> Message:
    tag, pos = _read_varint(payload, 0)
    if tag == IMAGE_START:
        w, pos = _read_varint(payload, pos)
        h, pos = _read_varint(payload, pos)
        spp, pos = _read_varint(payload, pos)
        return ImageStart(w, h, spp)
    if tag == PIXEL:
        row, pos = _read_varint(payload, pos)
        col, pos = _read_varint(payload, pos)
        if len(payload) - pos < 12:
            raise ValueError("truncated pixel color")
        color = struct.unpack_from("<3f", payload, pos)
        return Pixel(row, col, color)
    if tag == IMAGE_END:
        return ImageEnd()
    raise ValueError(f"unknown message tag {tag}")


def iter_frames(data: Iterable[int]) -> Iterator[bytes]:
    """Split a byte stream into COBS frames on 0x00."""
    buf = bytearray()
    for b in data:
        if b == 0:
            if buf:
                yield bytes(buf)
                buf.clear()
        else:
            buf.append(b)
    if buf:
        yield bytes(buf)


class ImageReceiver:
    """Reassembles a streamed image; skips malformed frames and counts
    them, as the reference's receiver does."""

    def __init__(self, rotate180: bool = False):
        self.image: Optional[np.ndarray] = None
        self.spp = 1
        self.pixels_received = 0
        self.errors = 0
        self.done = False
        self.rotate180 = rotate180
        # A tailing reader hands over arbitrary read chunks, and every frame
        # ends in 0x00: the bytes after the last delimiter are an incomplete
        # frame, held back until the next feed().
        self._carry = bytearray()

    def feed(self, data: bytes) -> None:
        buf = bytes(self._carry) + bytes(data)
        last = buf.rfind(0)
        if last < 0:
            self._carry = bytearray(buf)
            return
        self._carry = bytearray(buf[last + 1:])
        for frame in iter_frames(buf[:last + 1]):
            try:
                msg = decode_payload(cobs_decode(frame))
            except ValueError:
                self.errors += 1
                continue
            self._apply(msg)

    def _apply(self, msg: Message) -> None:
        if isinstance(msg, ImageStart):
            self.image = np.zeros((msg.height, msg.width, 3), np.float32)
            self.spp = msg.samples_per_pixel
            self.pixels_received = 0
            self.done = False
        elif isinstance(msg, Pixel) and self.image is not None:
            h, w, _ = self.image.shape
            if msg.row < h and msg.column < w:
                self.image[msg.row, msg.column] = msg.color
                self.pixels_received += 1
        elif isinstance(msg, ImageEnd):
            self.done = True
            if self.image is not None and self.rotate180:
                self.image = self.image[::-1, ::-1]

    def tone_mapped(self) -> np.ndarray:
        from raytracer_weekend_tpu_torch.utils.image import tone_map

        if self.image is None:
            raise RuntimeError("no ImageStart received")
        return tone_map(self.image, self.spp)


def stream_render(scene, static, cfg, cam, sink: Callable[[bytes], None],
                  chunk_pixels: int = 4096) -> np.ndarray:
    """Render chunk by chunk, streaming each finished pixel to `sink` ->
    the full (H, W, 3) color-sum image (numpy).

    A resync preamble of four 0x00 bytes, ImageStart, then one Pixel frame
    per pixel as its chunk's spp samples complete (rows from the top), then
    ImageEnd. Each chunk goes through the staged path on the scene's
    device.
    """
    import torch

    from raytracer_weekend_tpu_torch import integrator

    sink(b"\x00\x00\x00\x00")
    sink(encode_message(ImageStart(cfg.width, cfg.height,
                                   cfg.samples_per_pixel)))

    spp = cfg.samples_per_pixel
    out = np.zeros((cfg.n_pixels, 3), np.float32)
    for start in range(0, cfg.n_pixels, chunk_pixels):
        stop = min(start + chunk_pixels, cfg.n_pixels)
        lanes = torch.arange(start * spp, stop * spp, dtype=torch.int64,
                             device=scene.device)
        with torch.no_grad():
            colors = integrator.render_chunk(scene, static, cfg, cam, lanes,
                                             cfg.seed)
        sums = colors.reshape(stop - start, spp, 3).sum(dim=1).cpu().numpy()
        out[start:stop] = sums
        for i, pix in enumerate(range(start, stop)):
            row, col = divmod(pix, cfg.width)
            sink(encode_message(Pixel(row, col, tuple(float(x)
                                                      for x in sums[i]))))
    sink(encode_message(ImageEnd()))
    return out.reshape(cfg.height, cfg.width, 3)
