"""Scene validation and numerical self-checks (port of `utils/debug.py`).

The failure modes of a scene are numerical (NaN/inf) and referential (bad
table indices). `validate_scene` audits a compiled scene's tables;
`check_render_finite` traces a small lane sample through the staged path
(`integrator.render_chunk`) on the scene's device and raises on non-finite
radiance.
"""

from __future__ import annotations

import numpy as np
import torch


class SceneValidationError(ValueError):
    pass


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def validate_scene(scene, static) -> None:
    """Raise SceneValidationError on inconsistent tables."""
    errs = []

    def finite(name, arr):
        if not np.isfinite(_host(arr)).all():
            errs.append(f"{name} contains NaN/inf")

    def idx_in(name, arr, n):
        a = _host(arr)
        if a.size and (a.min() < 0 or a.max() >= n):
            errs.append(f"{name} indexes out of range [0,{n})")

    n_mat = int(scene.materials.mtype.shape[0])
    n_tex = int(scene.textures.ttype.shape[0])

    for fam in ("spheres", "rects", "triangles", "volumes"):
        table = getattr(scene, fam)
        for field in table._fields:
            if field == "valid":
                continue
            arr = getattr(table, field)
            if arr.is_floating_point():
                finite(f"{fam}.{field}", arr)
        idx_in(f"{fam}.mat", table.mat, n_mat)

    idx_in("materials.tex", scene.materials.tex, n_tex)
    finite("materials.fuzz", scene.materials.fuzz)
    if (_host(scene.materials.fuzz) > 1.0 + 1e-6).any():
        errs.append("metal fuzz > 1 (reference asserts fuzz <= 1, "
                    "material.rs:70-74)")
    if (_host(scene.materials.ior) <= 0).any():
        errs.append("non-positive IOR")
    finite("textures.color1", scene.textures.color1)
    finite("textures.images", scene.textures.images)

    sp = scene.spheres
    if (_host(sp.t1) - _host(sp.t0) == 0).any():
        errs.append("sphere t1 == t0 (center_at_time division by zero)")

    if errs:
        raise SceneValidationError("; ".join(errs))


def check_render_finite(scene, static, cfg, cam, n_lanes: int = 1024):
    """Trace the first `n_lanes` lanes through `render_chunk` on the scene's
    device and raise FloatingPointError on non-finite radiance ->
    (n, 3) numpy colors."""
    from raytracer_weekend_tpu_torch import integrator

    ids = torch.arange(min(n_lanes, cfg.n_rays), dtype=torch.int64,
                       device=scene.device)
    with torch.no_grad():
        colors = integrator.render_chunk(scene, static, cfg, cam, ids,
                                         cfg.seed).cpu().numpy()
    bad = ~np.isfinite(colors).all(axis=-1)
    if bad.any():
        raise FloatingPointError(
            f"{bad.sum()}/{len(bad)} lanes produced non-finite radiance; "
            f"first bad lane {int(np.argmax(bad))}")
    return colors
