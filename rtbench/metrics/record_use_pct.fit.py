"""Of the deferred records' slots the fit's forward launches laid out (the
program's counter `record_slots`: lanes x bounces), the share that holds a
record (its counter `live_records`: dcode != 0): 100 * live_records /
record_slots over the traced window. How much of the dense lanes x depth
combine is live work."""

from rtbench import program_trace as P


def read(out):
    c = P.counters()
    if not c.get("record_slots") or "live_records" not in c:
        return None
    return 100.0 * c["live_records"] / c["record_slots"]
