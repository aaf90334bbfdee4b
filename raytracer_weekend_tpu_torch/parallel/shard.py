"""Sharded rendering and the sharded inverse-rendering step (port of
`parallel/shard.py`).

One shard body runs in every rank of a (rays, spp, geom) mesh
(`parallel.mesh`):

  * film pixels split into contiguous blocks over `rays` (no collective
    until the frame is gathered);
  * a pixel's samples split into blocks over `spp`, summed over the axis
    once at the end;
  * the sphere and triangle tables split into row slices over `geom`; each
    geometry rank walks its own slice (its own tree where the scene has
    one), and every bounce combines the closest hit and the hit record over
    the axis (`integrator.trace_lanes(geom=...)`).

A lane's random numbers key on its (pixel, sample) id, so the image does not
depend on the mesh: on a rays-only mesh it is the single-device
`integrator.render_image` bit for bit (the same lanes, the same order of the
spp sum), and with an spp axis it differs only by the order of that sum.

Gradients: the collectives are differentiable (`ops.collectives.all_sum`:
the backward of a sum over an axis sums the cotangents over it), every
rank holds the whole scene and returns the whole frame, so every rank
counts the loss once and weights it by 1 / (ranks in the mesh);
`reduce_gradients` then sums the leaves' gradients over the world, as DDP
does, and each rank applies the same update to its copy (`train_step`,
`train.InverseRenderer(rmesh=...)`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raytracer_weekend_tpu_torch import integrator
from raytracer_weekend_tpu_torch.camera import Camera
from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.ops.collectives import all_sum
from raytracer_weekend_tpu_torch.parallel.mesh import RenderMesh
from raytracer_weekend_tpu_torch.scene import builder
from raytracer_weekend_tpu_torch.scene.data import SceneData, SceneStatic


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """`x` with rows of `fill` appended up to a multiple of `n` rows."""
    extra = -x.shape[0] % n
    if extra == 0:
        return x
    pad = torch.full((extra, *x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def pad_scene_for_geom(scene: SceneData, n_geom: int) -> SceneData:
    """Pad the sphere and triangle tables to a multiple of the geom axis
    size (JAX `pad_scene_for_geom`'s tables): sphere rows with radius 1,
    t1 1, valid False and zeros elsewhere; triangle rows with zeros and
    valid False. The kernels and the trees reject rows with valid False;
    every other table is replicated. The trees are left as they are:
    `shard_scene` builds each slice's own."""
    if n_geom == 1:
        return scene
    sp, tr = scene.spheres, scene.triangles
    sp = type(sp)(*[
        _pad_rows(getattr(sp, f), n_geom,
                  False if f == "valid" else (1 if f in ("radius", "t1")
                                              else 0))
        for f in sp._fields])
    tr = type(tr)(*[
        _pad_rows(getattr(tr, f), n_geom, False if f == "valid" else 0)
        for f in tr._fields])
    return scene._replace(spheres=sp, triangles=tr)


def shard_tree(kind: str, table):
    """The tree of one table slice over its local rows (the JAX
    `_stacked_shard_bvhs` build of one shard, without the padding nodes
    that stack the shards for a PartitionSpec), built by the port's C++
    builder from the detached fields, on the slice's device. Built anew on
    every call: a cache keyed by the fields' ids would miss an in-place
    update (an Adam step keeps a tensor's id)."""
    cpu = type(table)(*(t.detach().cpu() for t in table))
    build = builder._sphere_bvh if kind == "spheres" else \
        builder._triangle_bvh
    return build(cpu).to(table[0].device)


def shard_scene(scene: SceneData, n_geom: int, g: int) -> SceneData:
    """Geometry rank g's scene: the padded sphere and triangle tables' g-th
    row slice (the rows a shard_map with the geom PartitionSpec gives
    device g), each family with a tree in `scene` getting the tree of its
    slice over local rows; every other table replicated. Slicing keeps the
    autograd graph: the slice's gradients reach the scene's leaves."""
    if n_geom == 1:
        return scene
    scene = pad_scene_for_geom(scene, n_geom)

    def part(table):
        rows = table[0].shape[0] // n_geom
        return type(table)(*(t[g * rows:(g + 1) * rows] for t in table))

    sp, tr = part(scene.spheres), part(scene.triangles)
    return scene._replace(
        spheres=sp, triangles=tr,
        sphere_bvh=(None if scene.sphere_bvh is None
                    else shard_tree("spheres", sp)),
        triangle_bvh=(None if scene.triangle_bvh is None
                      else shard_tree("triangles", tr)))


def make_shard_body(static: SceneStatic, cfg: RenderConfig,
                    rmesh: RenderMesh, seed=None, diff: bool = False):
    """The one shard body, shared by `render_sharded` and
    `multihost.render_multihost` -> body(scene, cam) -> (this rank's pixel
    block of color sums (Pl, 3), summed over the spp axis; the segments its
    lanes traced, a 0-d int64 tensor, or None under `diff`).

    The rank's lanes are `pix * spp + smp` for the pixels of its rays block
    and the samples of its spp block; pixels and samples past the frame
    (the blocks are padded to equal sizes) are not traced and sum to 0, as
    JAX masks them (`shard.py:214-218`). On a rays-only mesh a scene that
    `integrator.fused_eligible` admits renders its lanes, one contiguous
    range, through `render_fused` (`render_fused_diff` with `diff`) in
    `cfg.ray_batch` chunks, as `render_image` does; the depth-phased route
    takes only a whole frame, so it runs only on a mesh of one rank. Any
    other mesh or scene takes the staged path (`render_chunk`, under
    autograd), with the geom axis.
    """
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    r, s, g = rmesh.coord
    Pl = -(-n_pix // rmesh.n_rays)
    Sl = -(-spp // rmesh.n_spp)
    pix0, s0 = r * Pl, s * Sl
    Pv = max(0, min(Pl, n_pix - pix0))
    Sv = max(0, min(Sl, spp - s0))
    seed = cfg.seed if seed is None else int(seed)
    device = rmesh.device
    use_fused = (rmesh.n_spp == 1 and rmesh.n_geom == 1
                 and integrator.fused_eligible(static, cfg, device))
    n = Pv * Sv
    batch = cfg.ray_batch or max(n, 1)

    def fused_chunk(scene, cam, start, size):
        if diff:
            from raytracer_weekend_tpu_torch.fused_diff import (
                render_fused_diff)
            return render_fused_diff(scene, static, cfg, cam, start, size,
                                     seed), None
        from raytracer_weekend_tpu_torch.ops.cuda.megakernel import (
            render_fused)
        rad, seg = render_fused(scene, cfg, cam, start, size, seed,
                                static=static)
        return rad, seg.sum(dtype=torch.int64)

    def body(scene: SceneData, cam: Camera):
        colors, segs = [], []
        if use_fused:
            lane0 = pix0 * spp
            for start in range(0, n, batch):
                c, k = fused_chunk(scene, cam, lane0 + start,
                                   min(batch, n - start))
                colors.append(c)
                segs.append(k)
        elif n:
            local = shard_scene(scene, rmesh.n_geom, g)
            pix = torch.arange(pix0, pix0 + Pv, dtype=torch.int64,
                               device=device)
            smp = torch.arange(s0, s0 + Sv, dtype=torch.int64, device=device)
            ids = (pix[:, None] * spp + smp[None, :]).reshape(-1)
            for start in range(0, n, batch):
                c, k = integrator.render_chunk(
                    local, static, cfg, cam, ids[start:start + batch], seed,
                    return_stats=True, geom=rmesh.geom)
                colors.append(c)
                segs.append(k)
        if colors:
            lanes = colors[0] if len(colors) == 1 else torch.cat(colors)
            block = lanes.reshape(Pv, Sv, 3).sum(dim=1)
        else:
            block = torch.zeros((Pv, 3), device=device)
        block = F.pad(block, (0, 0, 0, Pl - Pv))
        if (not block.requires_grad and torch.is_grad_enabled()
                and any(t.requires_grad for t in scene.leaves())):
            # A rank with no lanes (a sample block past spp) still joins
            # the backward's collectives of its axes.
            block.requires_grad_()
        traced = None if diff else sum(
            segs, torch.zeros((), dtype=torch.int64, device=device))
        return all_sum(block, rmesh.spp), traced

    return body


def render_sharded(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                   cam: Camera, rmesh: RenderMesh, seed=None,
                   diff: bool = False, return_segments: bool = False):
    """Full-frame sharded render -> (H, W, 3) color sums over spp, the same
    on every rank (with `return_segments`, also the segments the frame
    traced, counted once per lane, a 0-d int64 tensor).

    Every rank of the mesh calls it with the same scene and camera, on its
    own device (`rmesh.device`). The spp axis sums its blocks; the rays
    blocks are gathered by a sum over the world to which only the ranks at
    spp and geom 0 contribute, so the frame keeps the autograd graph on
    every rank (`diff` renders for a gradient: `render_fused_diff` on the
    fused route). Equal to `integrator.render_image` up to the order of the
    spp sum (make_shard_body).
    """
    body = make_shard_body(static, cfg, rmesh, seed, diff)
    block, traced = body(scene, cam)
    r, s, g = rmesh.coord
    if rmesh.n_rays > 1:
        Pl = block.shape[0]
        mine = block if s == 0 and g == 0 else block * 0.0
        frame = F.pad(mine, (0, 0, r * Pl, (rmesh.n_rays - 1 - r) * Pl))
        block = all_sum(frame, rmesh.world)
    sums = block[:cfg.n_pixels].reshape(cfg.height, cfg.width, 3)
    if not return_segments:
        return sums
    if diff:
        raise ValueError("segments are not counted under diff")
    return sums, all_sum(traced if g == 0 else traced * 0, rmesh.world)


def render_image_sharded(scene, static, cfg, cam, rmesh, seed=None):
    """Alias mirroring integrator.render_image's name."""
    return render_sharded(scene, static, cfg, cam, rmesh, seed)


def reduce_gradients(params, rmesh: RenderMesh) -> list:
    """Each parameter's gradient summed over the world (zeros where a rank
    has none), written back to `.grad` and returned: the gradient of a loss
    every rank counted with the weight 1 / rmesh.size. One all_reduce of
    the gradients packed flat."""
    flat = all_sum(torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params]), rmesh.world)
    grads = [x.view_as(p) for x, p in zip(
        flat.split([p.numel() for p in params]), params)]
    for p, x in zip(params, grads):
        p.grad = x
    return grads


def train_step(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
               cam: Camera, target: torch.Tensor, rmesh: RenderMesh,
               lr: float = 0.1):
    """One inverse-rendering SGD step: L2(render / spp, target) over the
    mesh -> (updated scene, loss 0-d tensor), the same on every rank.

    The gradient is `train.InverseRenderer(rmesh=rmesh).value_and_grad`'s:
    each rank's loss counts with the weight 1 / (ranks in the mesh) and the
    gradients are summed over the world, so the step is the single-device
    step, not a multiple of it. Every rank then moves each float leaf by -lr
    times its gradient; integer and bool leaves stay as they are. The scene
    passed in is not modified."""
    from raytracer_weekend_tpu_torch.train import InverseRenderer

    loss, grads = InverseRenderer(static, cfg, cam, target,
                                  rmesh=rmesh).value_and_grad(scene)
    grads = iter(grads)
    with torch.no_grad():
        new = [t - lr * next(grads) if t.is_floating_point() else t
               for t in scene.leaves()]
    return SceneData.from_leaves(new, scene.trees), torch.tensor(loss)
