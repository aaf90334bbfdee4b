"""Of the lane-bounces the depth phases launched (the program's counter
`phase_lane_bounces`: each phased launch's lanes x its bounces), the share
launched on the persistent warps that refill a lane slot as soon as its
lane ends (its counter `refill_lane_bounces`: the same, of the launches on
`media_kernel`): 100 * refill_lane_bounces / phase_lane_bounces over the
traced window. None where the program has no such counter."""

from rtbench import program_trace as P


def read(out):
    c = P.counters()
    if not c.get("phase_lane_bounces") or "refill_lane_bounces" not in c:
        return None
    return 100.0 * c["refill_lane_bounces"] / c["phase_lane_bounces"]
