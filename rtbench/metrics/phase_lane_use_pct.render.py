"""Of the lane-bounces the depth phases launched (the program's counter
`phase_lane_bounces`: each phased launch's lanes x its bounces), the share
that traced a segment (its counter `segments`): 100 * segments /
phase_lane_bounces over the traced window."""

from rtbench import program_trace as P


def read(out):
    c = P.counters()
    if not c.get("phase_lane_bounces") or "segments" not in c:
        return None
    return 100.0 * c["segments"] / c["phase_lane_bounces"]
