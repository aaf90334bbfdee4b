"""Timers of a launch or a call on the card, shared by `chip_smoke.py` and
`utils/ab_render.py`.

`cuda_ms` brackets `fn()` with CUDA events, so it also holds the host's
enqueue of the work (allocations, a counter's zeroing, a ctypes call).
`device_ms` queues the start event behind a spin of the card, so that the
host's enqueue overlaps the spin and only the device's work is timed.
`host_ms` reads the host's clock between two synchronizations of the card,
as a caller that waits for the result sees the call.
"""

from __future__ import annotations

import statistics
import time


def cuda_ms(fn, reps=5):
    """Median milliseconds of `fn()` over `reps` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, reps=21):
    """Median milliseconds of `fn`'s device work over `reps` runs: the start
    event is queued behind a ~3 ms spin of the card, so the host's
    enqueueing overlaps it."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_ms(fn, reps=3):
    """Median milliseconds of `fn()` over `reps` runs by the host's clock,
    each run between two synchronizations of the card."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
