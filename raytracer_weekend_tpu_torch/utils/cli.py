"""Console front end (port of `utils/cli.py`).

The reference CLI's surface: a scene name plus --width / --aspect-ratio /
--samples-per-pixel (defaults 400 / 16:9 / 100), rendering every camera
of the scene to OUT/image_NNNN.png with the reference's tone map; and the
JAX package's extras: --max-depth, --seed, --ray-batch, --pallas,
--stream, --resume-dir.

    python -m raytracer_weekend_tpu_torch.utils.cli cornell_box -w 200 -s 50

It runs on the card and raises where torch sees none; --cpu renders on the
CPU instead (the plain versions of every kernel). The default route is
`integrator.render_image` (the megakernel for the scenes it covers, else
the staged path); --stream and --resume-dir take the staged path
(`integrator.render_chunk`) chunk by chunk.

--mesh R,S,G renders through `parallel.shard.render_sharded` on a (rays,
spp, geom) mesh of that shape. Under `torchrun` (which sets WORLD_SIZE) it
joins the world through `env://` (`parallel.mesh.distributed_init`: nccl
when every rank has a card of its own, else gloo), and only rank 0 prints
and writes PNGs:

    torchrun --nproc-per-node 4 -m raytracer_weekend_tpu_torch.utils.cli \
        cornell_box -w 200 -s 16 --cpu --mesh 2,1,2

Without a world it is one rank, so only --mesh 1,1,1 runs; a larger shape
exits with an error that names the world size.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from raytracer_weekend_tpu_torch.config import RenderConfig
from raytracer_weekend_tpu_torch.models.scenes import SCENES, generate_scene
from raytracer_weekend_tpu_torch.utils.image import save_png, tone_map


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_weekend_tpu_torch",
        description="Differentiable path tracer on PyTorch and CUDA "
                    "(the reference's scene presets)")
    p.add_argument("scene", choices=sorted(SCENES), help="scene preset")
    p.add_argument("-w", "--width", type=int, default=400)
    p.add_argument("-a", "--aspect-ratio", type=float, default=16.0 / 9.0)
    p.add_argument("-s", "--samples-per-pixel", type=int, default=100)
    p.add_argument("-d", "--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ray-batch", type=int, default=1 << 20,
                   help="rays per wavefront megabatch (0 = all at once)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh shape rays,spp,geom (the ranks of a "
                        "torchrun world)")
    p.add_argument("-o", "--out-dir", default="render")
    p.add_argument("--pallas", action="store_true",
                   help="force the kernels (use_pallas=True): the closest-"
                        "hit kernels K10-K12 on the staged path, whatever "
                        "the scene's trees")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    p.add_argument("--stream", metavar="PATH", default=None,
                   help="also emit the COBS/postcard pixel stream (the "
                        "reference's UART wire format) to PATH")
    p.add_argument("--resume-dir", metavar="DIR", default=None,
                   help="tile checkpoint dir: resume a partial render")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if not args.mesh:
        return _render_frames(args, device, None)
    from raytracer_weekend_tpu_torch.parallel import mesh as mesh_mod

    shape = tuple(int(x) for x in args.mesh.split(","))
    joined = "WORLD_SIZE" in os.environ and not mesh_mod.dist.is_initialized()
    if joined:
        mesh_mod.distributed_init(device=device, init_method="env://")
    try:
        try:
            rmesh = mesh_mod.make_render_mesh(shape, device=device)
        except ValueError as e:
            print(f"--mesh: {e}", file=sys.stderr)
            return 2
        return _render_frames(args, rmesh.device, rmesh)
    finally:
        if joined:
            mesh_mod.dist.destroy_process_group()


def _render_frames(args, device, rmesh) -> int:
    lead = rmesh is None or rmesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    cfg = RenderConfig.from_aspect(
        width=args.width, aspect_ratio=args.aspect_ratio,
        samples_per_pixel=args.samples_per_pixel, max_depth=args.max_depth,
        seed=args.seed, ray_batch=args.ray_batch,
        use_pallas=True if args.pallas else "auto")

    say(f"building scene {args.scene!r} on {device} ...", flush=True)
    scene, static, cams = generate_scene(args.scene, cfg.aspect_ratio,
                                         seed=args.seed, device=device)
    say(f"  {static.n_spheres} spheres, {static.n_rects} rects, "
        f"{static.n_triangles} triangles, {static.n_volumes} volumes; "
        f"trees: spheres {static.sphere_bvh}, triangles "
        f"{static.triangle_bvh}")

    if rmesh is not None:
        say(f"  mesh {rmesh.shape} (rays, spp, geom) over "
            f"{rmesh.size} ranks")
    if lead:
        os.makedirs(args.out_dir, exist_ok=True)

    for frame_no, cam in enumerate(cams):
        t0 = time.time()

        def progress(done, total):
            rate = done / max(time.time() - t0, 1e-9)
            sys.stderr.write(
                f"\rframe {frame_no + 1}/{len(cams)}: {done}/{total} rays "
                f"({rate / 1e6:.2f} Mrays/s)")
            sys.stderr.flush()

        if rmesh is not None:
            import torch

            from raytracer_weekend_tpu_torch.parallel.shard import (
                render_sharded)
            with torch.no_grad():
                sums = render_sharded(scene, static, cfg, cam,
                                      rmesh).cpu().numpy()
        elif args.stream is not None:
            from raytracer_weekend_tpu_torch.parallel.stream import (
                stream_render)
            with open(args.stream, "ab") as f:
                sums = stream_render(scene, static, cfg, cam, f.write)
        elif args.resume_dir is not None:
            from raytracer_weekend_tpu_torch.utils.checkpoint import (
                TileStore, render_resumable)
            sums = render_resumable(scene, static, cfg, cam,
                                    TileStore(args.resume_dir),
                                    frame=frame_no)
        else:
            import torch

            from raytracer_weekend_tpu_torch import integrator
            with torch.no_grad():
                sums = integrator.render_image(
                    scene, static, cfg, cam, progress=progress).cpu().numpy()
        dt = time.time() - t0
        if not lead:
            continue
        sys.stderr.write("\n")

        img = tone_map(np.asarray(sums), cfg.samples_per_pixel)
        path = os.path.join(args.out_dir, f"image_{frame_no:04d}.png")
        save_png(path, img)
        print(f"frame {frame_no}: {dt:.2f}s "
              f"({cfg.n_rays / dt / 1e6:.2f} Mrays/s primary) -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
