"""What every cell's run shares: the manifest and its data files, seeds, the
device's description, the check for JAX, and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent          # rtbench/
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_weekend_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = REPO / "BENCHMARK.json") -> dict:
    return load_json(path)


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its data files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list
    limits: dict            # limits/<cell>.json: each checked number's limit

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def find_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest, its configuration, traffic and
    limits read from the configuration's file, `traffic/<traffic>.json`
    and `limits/<name>.json` under `root` (the benchmark's directory)."""
    bench = bench or manifest(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root.parent / configs[w["config"]]["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if m["name"] == "setup_s" or "workloads" not in m
           or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    limits = load_json(root / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                limits)


def load_module(path: Path):
    """A module from a file whose name may hold dots (a metric's reader)."""
    spec = importlib.util.spec_from_file_location(
        "rtbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The traffic driver `drivers/<kind>.py`."""
    return importlib.import_module(f"rtbench.drivers.{kind}")


def reader(metric: str):
    """The per-layer metric's reader `metrics/<metric>.py`."""
    return load_module(ROOT / "metrics" / f"{metric}.py")


def derive(seed: int, *keys: int) -> int:
    """A 31-bit seed for one use of the run's seed (`keys` name the use)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *map(int, keys)])
    return int(ss.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


# Uses of the run's seed, the first key of `derive`.
PASS, WARM, CHECK = 1, 2, 3


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def note(msg: str) -> None:
    """A line of the run's account on standard error."""
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    dev = torch.device("cuda") if torch.cuda.is_available() else None
    return {"platform": "gpu" if dev is not None else "cpu",
            "kind": torch.cuda.get_device_name(0) if dev is not None
            else "cpu", "count": count, "memory_peak_bytes": int(peak_bytes)}


def quantile95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
