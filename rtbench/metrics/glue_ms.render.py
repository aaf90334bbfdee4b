"""Device milliseconds a pass of every operation that is not a port kernel
(PyTorch's kernels, copies and fills): the megakernel wrapper's table
build, the combine, the depth phases' gathers and the accumulation."""


def read(out):
    t = out.get("trace")
    if t is None or not out["units"]:
        return None
    return t.nonport_s() * 1e3 / out["units"]
