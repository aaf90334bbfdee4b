"""The port's kernels' share of their roofline a pass: the frozen count's
least time (rtbench/reference/roofline.py: segments x a fixed count of
operations a segment against 67 TFLOP/s, bytes read and written once
against 3.35 TB/s) over the kernels' device time a pass. Never above 100%
unless the count or the time is wrong."""

from rtbench.reference import roofline


def read(out):
    t = out.get("trace")
    if t is None or not out["units"]:
        return None
    s = t.port_s()
    if s <= 0:
        return None
    bound, _ = roofline.bound_seconds(*out["work"])
    return 100.0 * bound / (s / out["units"])
