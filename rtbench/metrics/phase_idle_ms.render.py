"""Device-idle milliseconds a pass inside the program's `rtw.fused.deep`
spans (the depth-phased render): each interval of the traced window in
which no device operation ran, counted by its overlap with those spans.
The rest of the window's idle falls between the phased renders."""

from rtbench import program_trace as P


def read(out):
    deep = P.intervals(out, "rtw.fused.deep")
    if not deep:
        return None
    return P.ms_per_unit(out, P.overlap_s(P.idle_intervals(out["trace"]),
                                          deep))
