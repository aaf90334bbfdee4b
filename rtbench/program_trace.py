"""What the program's own tracer recorded, for the readers of its spans and
counters (`raytracer_weekend_tpu_torch.utils.metrics`): its `rtw.` spans in
the traced window (host spans, on the clock of the device's kernels), its
counters, which accumulate only while the profiler records (so in a
benchmark process they are the traced window's), and its set-up spans on
`time.perf_counter`. A program without the tracer gives none of them, and
each reader then returns None.
"""

from __future__ import annotations


def intervals(out, name: str) -> list:
    """The program's spans `name` in the traced window, clipped to it, as
    sorted (start, end) seconds; [] without a trace."""
    t = out.get("trace")
    if t is None:
        return []
    lo, hi = t.window
    return sorted((max(s.start, lo), min(s.start + s.dur, hi))
                  for s in t.spans
                  if s.name == name and s.start < hi and s.start + s.dur > lo)


def idle_intervals(t) -> list:
    """The window's intervals in which no device operation ran, sorted."""
    lo, hi = t.window
    gaps, cur = [], lo
    for s, e in sorted((o.start, o.start + o.dur) for o in t.in_window()):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def overlap_s(a: list, b: list) -> float:
    """Seconds that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def ms_per_unit(out, seconds: float) -> float | None:
    return seconds * 1e3 / out["units"] if out["units"] else None


def span_ms(out, name: str) -> float | None:
    """Milliseconds a unit (a pass) inside the spans `name`; None where the
    window has none."""
    iv = intervals(out, name)
    return ms_per_unit(out, sum(e - s for s, e in iv)) if iv else None


def counters() -> dict:
    """The program's counters (totals), or {} where it has none."""
    try:
        from raytracer_weekend_tpu_torch.utils.metrics import counters
    except ImportError:
        return {}
    return counters()


def setup_seconds(name: str) -> float | None:
    """Seconds inside the program's set-up spans `name`; None where there
    are none."""
    try:
        from raytracer_weekend_tpu_torch.utils.metrics import setup_spans
    except ImportError:
        return None
    got = [end - start for n, start, end in setup_spans() if n == name]
    return sum(got) if got else None
