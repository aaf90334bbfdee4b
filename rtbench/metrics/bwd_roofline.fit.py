"""The fit's backward kernels' share of their roofline: the frozen count of
a step's backward (rtbench/reference/roofline_fit.py: each segment
recomputed and differentiated, every float leaf's gradient written once)
over the device time a step of the port kernels launched inside the
program's `rtw.diff.backward` spans (K2 with K7, and their order kernels).
Never above 100% unless the count or the time is wrong."""

from rtbench import fit_trace


def read(out):
    return fit_trace.roofline_pct(out, "rtw.diff.backward", "backward")
