"""The fit's forward kernels' share of their roofline: the frozen count of
a step's forward (rtbench/reference/roofline_fit.py: a render pass, and
each segment's code and record written once) over the device time a step
of the port kernels launched inside the program's `rtw.diff.forward`
spans (K1-emit, K6a-emit). Never above 100% unless the count or the time
is wrong."""

from rtbench import fit_trace


def read(out):
    return fit_trace.roofline_pct(out, "rtw.diff.forward", "forward")
