"""The traced run: `torch.profiler` (CUPTI) around the window, read back
from its Chrome trace into device intervals, launches and host spans.

A device kernel is the port's unless its name belongs to PyTorch (at::,
c10::, cub:: and the like), cuBLAS, cuDNN or NCCL; copies and fills are
neither. So a kernel that a later change adds to the program counts as the
port's without an edit here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

WINDOW_SPAN = "rtbench.window"

_LIBRARY = re.compile(
    r"at::|at_cuda_detail|c10::|cub::|thrust::|cutlass|cublas|cudnn|gemm|"
    r"nccl|\(anonymous namespace\)::(elementwise|reduce|vectorized|index)|"
    r"^void (elementwise|reduce|vectorized|index|unrolled)_|"
    r"[Mm]emcpy|[Mm]emset|triton_", re.IGNORECASE)


def is_port_kernel(name: str, cat: str = "kernel") -> bool:
    return cat == "kernel" and not _LIBRARY.search(name)


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str            # kernel, gpu_memcpy, gpu_memset
    start: float        # seconds on the trace's clock
    dur: float
    corr: int | None    # the launching runtime call's correlation id
    device: int


@dataclasses.dataclass
class Span:
    name: str
    tid: object
    start: float
    dur: float


@dataclasses.dataclass
class TraceData:
    ops: list                     # DeviceOp
    launches: dict                # correlation id -> Span (runtime call)
    spans: list                   # host spans: cpu ops and annotations
    window: tuple                 # (start, end) of the traced window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self):
        lo, hi = self.window
        return [o for o in self.ops if o.start < hi and o.start + o.dur > lo]

    def busy_s(self) -> float:
        """Seconds of the window in which any device op ran (union)."""
        lo, hi = self.window
        iv = sorted((max(o.start, lo), min(o.start + o.dur, hi))
                    for o in self.in_window())
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def seconds(self, pred) -> float:
        return sum(o.dur for o in self.in_window() if pred(o))

    def port_s(self) -> float:
        return self.seconds(lambda o: is_port_kernel(o.name, o.cat))

    def nonport_s(self) -> float:
        return self.seconds(lambda o: not is_port_kernel(o.name, o.cat))

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (by name) and the longest
        idle gaps of the window, each named by what the host was doing."""
        by_name: dict = {}
        for o in self.in_window():
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        iv = sorted((o.start, o.start + o.dur) for o in self.in_window())
        gaps, cur = [], lo
        for s, e in iv:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            inside = [sp for sp in self.spans
                      if sp.start <= mid <= sp.start + sp.dur
                      and sp.name != WINDOW_SPAN]
            name = (min(inside, key=lambda sp: sp.dur).name if inside
                    else "host outside any traced op")
            out.append([name[:200], e - s])
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": out}


def read_chrome_trace(path: str) -> TraceData:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, launches, spans, window = [], {}, [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {}) or {}
        start, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append(DeviceOp(ev["name"], cat, start, dur,
                                args.get("correlation"),
                                int(args.get("device", 0) or 0)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = Span(ev["name"], ev.get("tid"),
                                                     start, dur)
        elif cat in ("cpu_op", "user_annotation"):
            spans.append(Span(ev["name"], ev.get("tid"), start, dur))
            if ev["name"] == WINDOW_SPAN and cat == "user_annotation":
                window = (start, start + dur)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return TraceData(ops, launches, spans, window)


class Profiler:
    """`torch.profiler` over CPU and CUDA; `data` after the block is the
    trace read back (the Chrome file is written under TMPDIR and removed)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.data: TraceData | None = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="rtbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.data = read_chrome_trace(path)
        finally:
            os.remove(path)
        return False
