"""Device milliseconds a pass of the port's own kernels (every kernel whose
name belongs to none of PyTorch, cuBLAS, cuDNN, NCCL), from the trace."""


def read(out):
    t = out.get("trace")
    if t is None or not out["units"]:
        return None
    s = t.port_s()
    return s * 1e3 / out["units"] if s > 0 else None
