"""Ray segments the program traced a pixel sample: its counter `segments`
(each render chunk's per-lane segments, summed on the card) over the
traced window's samples (samples_per_s x window_s). The configuration's
frozen `segments_per_sample` is the plain reference's count."""

from rtbench import program_trace as P


def read(out):
    segments = P.counters().get("segments")
    samples = out["samples_per_s"] * out["window_s"]
    if segments is None or samples <= 0:
        return None
    return segments / samples
