"""One run of one cell of the benchmark.

    python3 -m rtbench.run --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

It loads and warms up (the set-up), measures for `--seconds`, checks what
the window produced against the plain reference, and prints one JSON object
as the last line of its standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` `breakdown`, and last `checks`, each
number compared beside its limit (also the last lines of standard error).

It exits with 2 and prints no result when torch sees no card or fewer than
the cell asks for, and with 3 when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from rtbench import common  # noqa: E402


def _per_layer(cell: common.Cell, out: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    metrics = {}
    for m in cell.per_layer:
        value = common.reader(m["name"]).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def result(cell: common.Cell, out: dict, trace: bool) -> dict:
    """The result line's object."""
    checks = {name: {"value": v, "limit": lim} for name, v, lim in
              out["checks"]}
    correct = all(common.finite(v) and v <= lim for _, v, lim in
                  out["checks"])
    if trace:
        metrics = _per_layer(cell, out)
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = common.device_info(out["count"], out["peak"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and out.get("trace") is not None:
        data = out["trace"]
        device["busy_s"] = data.busy_s()
        device["window_s"] = data.window_s
        line["breakdown"] = data.breakdown()
    line["checks"] = checks
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             faults: dict | None = None,
             overrides: dict | None = None) -> dict:
    """Run cell `name` and return its result object. `device`, `faults` (a
    fault planted in the timed path) and `overrides` ({"config": {...},
    "traffic": {...}}, keys replaced in the cell's data, such as a smaller
    frame) serve the benchmark's own tests."""
    cell = common.find_cell(name)
    for part, changes in (overrides or {}).items():
        getattr(cell, part).update(changes)
    out = common.driver(cell.kind).run(
        cell, seed, seconds, trace, T_START if t_start is None else t_start,
        device=device, faults=faults)
    return result(cell, out, trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = common.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace))
    found = common.forbidden_modules()
    if found:
        print(f"rtbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    common.note(common.power_limit())
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
