"""What the benchmark imports: nothing of JAX or the JAX package (top-level
module names compared whole), and in the reference nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from rtbench import common

_PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(
        imports=imports)], cwd=common.REPO, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "",
                          "HOME": str(common.REPO)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    """The harness, every driver and reader, the reference, and the parts
    of the program that the drivers call."""
    readers = "".join(
        f"common.reader({p.stem!r})\n"
        for p in sorted((common.ROOT / "metrics").glob("*.py")))
    mods = _top_level_modules(
        "from rtbench import run, common, control, trace, port\n"
        "from rtbench.drivers import render_passes\n"
        "from rtbench.reference import (render, scenes, compare, rates,\n"
        "    roofline, count_segments)\n"
        "import raytracer_weekend_tpu_torch.integrator\n"
        "import raytracer_weekend_tpu_torch.camera\n"
        "import raytracer_weekend_tpu_torch.scene.builder\n" + readers)
    assert "rtbench" in mods and "raytracer_weekend_tpu_torch" in mods
    assert not mods & set(common.FORBIDDEN), mods & set(common.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    mods = _top_level_modules(
        "from rtbench.reference import (render, scenes, compare, rates,\n"
        "    roofline, count_segments)\n")
    assert "raytracer_weekend_tpu_torch" not in mods
    assert not mods & set(common.FORBIDDEN)


def test_forbidden_modules_compares_whole_names():
    assert "raytracer_weekend_tpu" in common.FORBIDDEN
    sys.modules.setdefault("raytracer_weekend_tpu_torch_probe_", sys)
    try:
        assert "raytracer_weekend_tpu_torch_probe_" not in \
            common.forbidden_modules()
    finally:
        del sys.modules["raytracer_weekend_tpu_torch_probe_"]
