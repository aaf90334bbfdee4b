"""Live-preview stream receiver: tail a pixel stream, update a PNG (port of
`utils/live_view.py`).

Runnable twin of the reference's GUI receiver, which reads COBS frames off
a serial port, deserializes ProgressMessage, accumulates pixels into an
image and tracks progress. Here the "display" is a PNG file rewritten in
place as pixels arrive (written by the standard library, `utils.image.
save_png`), which any image viewer live-reloads; progress goes to stderr.

Sources:
  * a file path — followed tail -f style, so it works on a stream file that
    a concurrent `cli.py --stream PATH` render is still appending to;
  * `-` — stdin (pipe a render straight in);
  * `tcp:PORT` — listen once on 127.0.0.1:PORT (the serial-port analog).

Usage:
    python -m raytracer_weekend_tpu_torch.utils.live_view render.stream -o live.png
"""

from __future__ import annotations

import argparse
import socket
import sys
import time
from typing import Iterator

from raytracer_weekend_tpu_torch.parallel.stream import ImageReceiver


def _iter_source(src: str, follow: bool, poll_s: float = 0.1,
                 idle_timeout: float | None = None) -> Iterator[bytes]:
    """Yield byte chunks from a file (tailed), stdin, or a TCP listener."""
    if src == "-":
        while True:
            chunk = sys.stdin.buffer.read1(65536)
            if not chunk:
                return
            yield chunk
    elif src.startswith("tcp:"):
        port = int(src[4:])
        with socket.socket() as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", port))
            srv.listen(1)
            conn, _ = srv.accept()
            with conn:
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    yield chunk
    else:
        idle = 0.0
        with open(src, "rb") as f:
            while True:
                chunk = f.read(65536)
                if chunk:
                    idle = 0.0
                    yield chunk
                elif not follow:
                    return
                else:
                    if idle_timeout is not None and idle >= idle_timeout:
                        return
                    time.sleep(poll_s)
                    idle += poll_s


def run(src: str, out: str, interval: float = 0.5, follow: bool = True,
        once: bool = False, idle_timeout: float | None = None,
        rotate180: bool = False, quiet: bool = False) -> ImageReceiver:
    """Feed the stream into an ImageReceiver, rewriting `out` periodically.

    Returns the receiver (tests inspect .image/.pixels_received/.done).
    """
    from raytracer_weekend_tpu_torch.utils.image import save_png

    rx = ImageReceiver(rotate180=rotate180)
    last_write = 0.0
    frames_done = 0
    final_flushed = False

    def flush(final: bool = False) -> None:
        nonlocal last_write, final_flushed
        if rx.image is None or final_flushed:
            return
        final_flushed = final
        save_png(out, rx.tone_mapped())
        last_write = time.monotonic()
        if not quiet:
            h, w, _ = rx.image.shape
            pct = 100.0 * rx.pixels_received / max(1, h * w)
            print(f"\r{rx.pixels_received}/{h * w} px ({pct:5.1f}%) "
                  f"errors={rx.errors}{' done' if final else ''}",
                  end="\n" if final else "", file=sys.stderr, flush=True)

    for chunk in _iter_source(src, follow=follow, idle_timeout=idle_timeout):
        was_done = rx.done
        rx.feed(chunk)
        if rx.done and not was_done:
            frames_done += 1
            flush(final=True)
            if once:
                break
        elif time.monotonic() - last_write >= interval:
            flush()
    flush(final=rx.done)
    return rx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Live PNG preview of a COBS pixel stream")
    p.add_argument("source", help="stream file to tail, '-' (stdin), or "
                                  "tcp:PORT to listen on")
    p.add_argument("-o", "--out", default="live.png",
                   help="PNG rewritten in place as pixels arrive")
    p.add_argument("--interval", type=float, default=0.5,
                   help="seconds between PNG rewrites")
    p.add_argument("--no-follow", action="store_true",
                   help="stop at EOF instead of tailing the file")
    p.add_argument("--once", action="store_true",
                   help="exit after the first complete image")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="stop tailing after this many idle seconds")
    p.add_argument("--rotate180", action="store_true",
                   help="flip the image like the embedded sender expects")
    args = p.parse_args(argv)
    rx = run(args.source, args.out, interval=args.interval,
             follow=not args.no_follow, once=args.once,
             idle_timeout=args.idle_timeout, rotate180=args.rotate180)
    return 0 if rx.image is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
