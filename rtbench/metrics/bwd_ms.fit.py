"""Host milliseconds a fit step inside the program's `rtw.diff.backward`
spans (`fused_diff._FusedDiff.backward`, whole: the combine's VJP, the
table packings, the replay-backward kernels and the autograd chain to the
leaves), from the traced window."""

from rtbench import program_trace as P


def read(out):
    return P.span_ms(out, "rtw.diff.backward")
