"""Share of the traced fit window in which no operation ran on the device:
100 * (1 - busy / window), busy the union of every kernel, copy and fill
of the window (the profiler's CUPTI trace)."""


def read(out):
    t = out.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
