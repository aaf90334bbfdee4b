"""Build and bind the port's CUDA kernels (nvcc into a shared library + ctypes).

The sources under `raytracer_weekend_tpu_torch/csrc/` are compiled at first
use with a plain C interface, no PyTorch headers, for `sm_90a`: one `nvcc`
per source, all started together, then one link into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

The library goes to `build/torch_kernels/` at the repository root, named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("megakernel.cu", "megakernel_vp.cu", "megakernel_media.cu",
           "replay_bwd.cu", "perlin_turb.cu", "intersect.cu", "bvh.cu",
           "combine.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_lib: ctypes.CDLL | None = None
_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtw_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library for them exists; return its path.

    The compiler's output (registers, spills) is kept beside the library as
    `<lib>.log`.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp-{os.getpid()}"
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{Path(s).stem}.{tag}.o")
            for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = []
    for c, p in zip(cmds, procs):
        stdout, stderr = p.communicate()
        results.append((c, p.returncode, stdout, stderr))
    tmp = out.with_name(f"{out.name}.{tag}")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, rc, _, _ in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
    log = out.with_name(out.name + ".log")
    log.write_text("".join(" ".join(c) + "\n" + o + e
                           for c, _, o, e in results))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(c, rc, e) for c, rc, _, e in results if rc != 0]
    if failed:
        c, rc, err = failed[0]
        raise RuntimeError(f"{' '.join(c)} failed ({rc}):\n{err}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures
    (the set-up span `rtw.setup.library`)."""
    global _lib
    if _lib is None:
        from raytracer_weekend_tpu_torch.utils import metrics

        with metrics.setup_span("rtw.setup.library"):
            _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    """The source hash, a build if stale, the load and the signatures."""
    lib = ctypes.CDLL(str(build()))
    lib.rtw_render_fused.argtypes = [_P, _I, _P, _P, _I, _P, _I, _P,
                                     _LL, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _F, _U, _I, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _I, _P, _P, _P]
    lib.rtw_render_fused.restype = _I
    lib.rtw_render_occupancy.argtypes = [_I, _I, _I, _I, _I, _P]
    lib.rtw_render_occupancy.restype = _I
    lib.rtw_plane_candidate.argtypes = [_P, _P, _P, _I, _F, _P, _P]
    lib.rtw_plane_candidate.restype = _I
    lib.rtw_replay_bwd.argtypes = [_P, _I, _P, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                   _U, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P]
    lib.rtw_replay_bwd.restype = _I
    lib.rtw_replay_bwd_order_ints.argtypes = [_I, _I]
    lib.rtw_replay_bwd_order_ints.restype = _LL
    lib.rtw_replay_bwd_smem_bytes.argtypes = [_I, _I]
    lib.rtw_replay_bwd_smem_bytes.restype = _LL
    lib.rtw_replay_bwd_smem_limit.argtypes = [_P]
    lib.rtw_replay_bwd_smem_limit.restype = _I
    lib.rtw_turbulence.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P,
                                   _P]
    lib.rtw_turbulence.restype = _I
    lib.rtw_turbulence_vjp.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P,
                                       _P, _P, _P]
    lib.rtw_turbulence_vjp.restype = _I
    lib.rtw_combine_images.argtypes = [_P, _I, _I, _P, _P, _I, _I, _P, _P,
                                       _P, _P, _P]
    lib.rtw_combine_images.restype = _I
    lib.rtw_combine_images_vjp.argtypes = [_P, _I, _I, _P, _P, _I, _I, _P,
                                           _P, _P, _P]
    lib.rtw_combine_images_vjp.restype = _I
    lib.rtw_hit_spheres.argtypes = [_P, _P, _P, _P, _I, _P, _I, _F, _P,
                                    _P, _P]
    lib.rtw_hit_rects.argtypes = [_P, _P, _I, _P, _I, _F, _P, _P, _P]
    lib.rtw_hit_triangles.argtypes = [_P, _P, _P, _I, _P, _I, _F, _P, _P,
                                      _P, _P]
    lib.rtw_tri_candidate.argtypes = [_P, _P, _P, _P, _P, _I, _F, _P, _P]
    lib.rtw_bvh_spheres.argtypes = [_P, _P, _P, _I, _P, _I, _P, _F, _P,
                                    _P, _P, _P]
    lib.rtw_bvh_triangles.argtypes = [_P, _P, _I, _P, _I, _P, _F, _P, _P,
                                      _P, _P]
    for fn in (lib.rtw_hit_spheres, lib.rtw_hit_rects,
               lib.rtw_hit_triangles, lib.rtw_tri_candidate,
               lib.rtw_bvh_spheres, lib.rtw_bvh_triangles):
        fn.restype = _I
    lib.rtw_rand4.argtypes = [_P, _I, _U, _U, _U, _P, _P]
    lib.rtw_rand4.restype = _I
    lib.rtw_error_string.argtypes = [_I]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.rtw_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch_closest_hit(entry: str, rays, tab, rows: int, t_min: float,
                       shape: tuple[int, int], tail=()):
    """One launch of a closest-hit kernel (K10-K12), the C function `entry`
    -> (t (n,) f32, +inf on a miss; idx (n,) int32).

    `rays` are the per-ray operands in the C entry's order, each with n rows;
    `tab` is the kernel's table of `rows` primitives, of `shape` (the
    family's layout); `tail` the tensors (or None, a null pointer) the entry
    takes after t and idx: K12's `divides`, a zeroed (1,) int64 tensor the
    pairs that took the division are added to. Every operand must be a
    contiguous float32 tensor on one CUDA device, and the table of `shape`
    on a 16-byte boundary (the kernels read float4 rows): anything else
    raises, as does a failed launch.
    """
    import torch

    device = tab.device
    n = rays[0].shape[0]
    for x in (*rays, tab):
        if (x.dtype != torch.float32 or x.device != device
                or device.type != "cuda" or not x.is_contiguous()):
            raise ValueError(f"{entry}: every operand must be a contiguous "
                             f"float32 CUDA tensor on one device; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if (any(x.shape[0] != n for x in rays) or n >= 2**31 or rows < 1
            or tuple(tab.shape) != tuple(shape) or tab.data_ptr() % 16):
        raise ValueError(f"{entry}: rays of {[tuple(x.shape) for x in rays]}"
                         f" against a table of {tuple(tab.shape)} (want "
                         f"{tuple(shape)}, 16-byte aligned)")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*(x.data_ptr() for x in rays), n,
                                  tab.data_ptr(), rows, float(t_min),
                                  t.data_ptr(), idx.data_ptr(),
                                  *(None if x is None else x.data_ptr()
                                    for x in tail), stream)
    check(lib, err, f"{entry} launch")
    return t, idx
