"""What a traced fit window holds, for the readers of the fit cells: the
port's kernels launched inside the program's `rtw.diff.forward` or
`rtw.diff.backward` spans (a kernel belongs to the span that holds the
host call that launched it, whatever its name), and the frozen count of
a step's work (`reference/roofline_fit.py`). None wherever there is
nothing to read: no trace, no such span (a program without the tracer),
no kernel inside it.
"""

from __future__ import annotations

from rtbench import program_trace as P
from rtbench.reference import roofline
from rtbench.trace import is_port_kernel


def kernel_seconds(out, span: str) -> float | None:
    """Device seconds of the port kernels launched inside spans `span`
    (clipped to the window); None where there are none."""
    t = out.get("trace")
    spans = P.intervals(out, span)
    if t is None or not spans:
        return None
    total = 0.0
    for o in t.in_window():
        call = t.launches.get(o.corr)
        if call is None or not is_port_kernel(o.name, o.cat):
            continue
        if any(s <= call.start <= e for s, e in spans):
            total += o.dur
    return total if total > 0 else None


def roofline_pct(out, span: str, part: str) -> float | None:
    """The frozen count's least time for a step's `part` ("forward" or
    "backward") over the device seconds a step of the port kernels
    launched inside `span`, in %."""
    s = kernel_seconds(out, span)
    work = out.get("work")
    if s is None or not work or not out["units"]:
        return None
    bound, _ = roofline.bound_seconds(*work[part])
    return 100.0 * bound / (s / out["units"])
