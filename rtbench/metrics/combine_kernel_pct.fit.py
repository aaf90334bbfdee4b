"""Of the deferred records' slots the fit's forward launches laid out (the
program's counter `record_slots`: lanes x bounces), the share that the
image-only combine's forward kernel combined (its counter
`combine_kernel_slots`: each launch's lanes x bounces): 100 *
combine_kernel_slots / record_slots over the traced window. How much of the
fit's combine left the torch ops. None where the program has no such
counter."""

from rtbench import program_trace as P


def read(out):
    c = P.counters()
    if not c.get("record_slots") or "combine_kernel_slots" not in c:
        return None
    return 100.0 * c["combine_kernel_slots"] / c["record_slots"]
