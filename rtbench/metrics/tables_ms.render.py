"""Host milliseconds a pass inside the program's `rtw.fused.tables` span
(`megakernel.build_tables`: the sphere, planar, test, volume and row tables
and the camera pack), from the traced window."""

from rtbench import program_trace as P


def read(out):
    return P.span_ms(out, "rtw.fused.tables")
