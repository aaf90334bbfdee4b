"""Host milliseconds a pass blocked inside the program's `rtw.deep.sync`
spans: each depth phase's live count, read back from the card. Host time,
which overlaps the device's work; from the traced window."""

from rtbench import program_trace as P


def read(out):
    return P.span_ms(out, "rtw.deep.sync")
