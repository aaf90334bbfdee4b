"""Host milliseconds a pass inside the program's `rtw.render_image` span
(`integrator.render_image`, the whole call), less the `rtw.deep.sync` spans
inside it (the depth phases' waits on the card): the wrapper's own host
work, from the traced window."""

from rtbench import program_trace as P


def read(out):
    calls = P.intervals(out, "rtw.render_image")
    if not calls:
        return None
    busy = sum(e - s for s, e in calls)
    waits = P.overlap_s(calls, P.intervals(out, "rtw.deep.sync"))
    return P.ms_per_unit(out, busy - waits)
