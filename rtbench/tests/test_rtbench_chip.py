"""On the card: each one-card cell's short run through the command line
prints a correct result line with every end-to-end metric, and a traced run
every per-layer metric the cell lists. Skips where torch sees no card.

    python -m pytest rtbench/tests/test_rtbench_chip.py -m gpu -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rtbench import common

CELLS = [w["name"] for w in common.manifest()["workloads"] if w["chips"] == 1]


def _needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name, trace):
    _needs_card()
    out = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload", name, "--seed",
         str(2 ** 33 + 7), "--seconds", "2", "--trace", str(trace)],
        cwd=common.REPO, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    cell = common.find_cell(name)
    assert line["correct"], line["checks"]
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
