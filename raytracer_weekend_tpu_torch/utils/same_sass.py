"""Which kernels differ between two checkouts' kernel libraries, by SASS.

    python raytracer_weekend_tpu_torch/utils/same_sass.py DIR

Run it from the root of a checkout; DIR is the root of another (for example
the parent commit, unpacked with `git archive` into a git-ignored
directory). Each checkout builds its own library with its own build code
(the two in parallel), and the script prints, kernel by kernel, "same",
"differs", "only here" or "only there", comparing their SASS (cuobjdump)
with addresses and encodings dropped. It needs the CUDA toolkit, not a card.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys


def kernel_sass(lib: pathlib.Path) -> dict:
    """{kernel: its SASS lines without addresses or encodings}."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    objdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(objdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        if ln.startswith("Fatbin "):  # the next object's header
            name = None
        ln = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip()
        if name and ln:
            out[name].append(ln)
    return out


def same_sass(here: pathlib.Path, other: pathlib.Path) -> dict:
    """{kernel: "same" | "differs" | "only here" | "only there"} between
    the library of the checkout at `here` and the one at `other`."""
    build = ("from raytracer_weekend_tpu_torch.ops.cuda import _build; "
             "print(_build.build())")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=root,
                              env={**os.environ, "PYTHONPATH": str(root)},
                              stdout=subprocess.PIPE, text=True)
             for root in (here, other)]
    libs = [pathlib.Path(p.communicate()[0].strip().splitlines()[-1])
            for p in procs]
    a, b = (kernel_sass(lib) for lib in libs)
    return {k: ("only here" if k not in b else "only there" if k not in a
                else "same" if a[k] == b[k] else "differs")
            for k in sorted(set(a) | set(b))}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    print(json.dumps(same_sass(pathlib.Path.cwd(),
                               pathlib.Path(sys.argv[1]).resolve()),
                     indent=1))
