"""The whole pass's share of the card's float32 peak (67 TFLOP/s): the frozen
count's operations a pass (rtbench/reference/roofline.py) over the traced
window's seconds a pass. It bounds every kernel's share from above, whatever
kernel a later change takes off the path."""

from rtbench.reference import roofline


def read(out):
    t = out.get("trace")
    if t is None or not out["units"] or t.window_s <= 0:
        return None
    ops, _ = out["work"]
    return 100.0 * ops / roofline.PEAK_FLOPS / (t.window_s / out["units"])
