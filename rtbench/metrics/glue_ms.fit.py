"""Device milliseconds a fit step of every operation that is not a port
kernel (PyTorch's kernels, copies and fills): the table builds, the
deferred combine and its autograd, the texel scatter, the autograd glue to
the leaves and Adam."""


def read(out):
    t = out.get("trace")
    if t is None or not out["units"]:
        return None
    return t.nonport_s() * 1e3 / out["units"]
