"""The image-only deferred combine: a forward and a VJP kernel, and twins.

For a scene whose deferred texels are image texels only (no noise), the
records (ctb, abc, dcode) of K6a fold into the radiance as
    rad = sum_k ctb_k * prod_{j<=k} f_j,
f_k the record's image texel (nearest fetch; 1 where dcode is 0), the
general combine of `megakernel.combine_deferred`. Here:

  * `combine_images` returns rad (n, 3), with `return_factors` also the
    factor product F (n, 3), continuing `init` = (rad, F) when given (the
    depth phases' chain): `combine_kernel` (`csrc/combine.cu`) for CUDA
    tensors, the plain `combine_deferred` for CPU tensors, which is what the
    kernel equals on the card bit for bit;
  * `combine_images_vjp` returns, for the radiance cotangent g (n, 3), the
    records' contribution cotangents g_k = g * prod_{j<=k} f_j (n, D, 3),
    the input K2/K7 take, and the gradient of the texel atlas:
    `combine_vjp_kernel` for CUDA tensors (live records only, atomically),
    `combine_images_vjp_reference` for CPU tensors.

Image texels are fetched nearest, so abc gets no cotangent. A build, load
or launch failure raises; nothing falls back to the plain version on a
card. The kernels replace no TPU kernel: the JAX `_combine_deferred` is jnp
code (see the note in `csrc/combine.cu`).
"""

from __future__ import annotations

import torch

from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda.megakernel import _check
from raytracer_weekend_tpu_torch.textures import TextureTable
from raytracer_weekend_tpu_torch.utils import metrics

# Launches of the forward kernel and of the VJP kernel in this process; only
# the launches in `combine_images` and `combine_images_vjp` add to them.
COMBINE_LAUNCHES = 0
COMBINE_VJP_LAUNCHES = 0


def combine_images_reference(textures: TextureTable, ctb, abc, dcode, *,
                             init=None, return_factors: bool = False):
    """Plain version of the forward kernel: `combine_deferred` without the
    noise arm."""
    return mk.combine_deferred(textures, ctb, abc, dcode, has_noise=False,
                               has_image=True, init=init,
                               return_factors=return_factors)


def combine_images_vjp_reference(textures: TextureTable, ctb, abc, dcode, g,
                                 *, texel_grad: bool = True):
    """Plain version of the VJP kernel -> (g_k (n, D, 3), d_images or None):
    g_k = g * P_k with P_k = prod_{j<=k} f_j, and at each live record j
    dL/df_j = g_{j-1} * S_j (g_{-1} = g), S_j = ctb_j + f_{j+1} * S_{j+1},
    added into the atlas by the backward of the texel fetch (dead records
    add 0)."""
    D = dcode.shape[1]
    with torch.enable_grad():
        images = textures.images.detach().requires_grad_(texel_grad)
        f = mk.deferred_texels(textures._replace(images=images), abc, dcode,
                               has_noise=False, has_image=True)
    fd = f.detach()
    g = g.to(torch.float32)
    cp, prods = None, []
    for k in range(D):
        cp = fd[:, k] if cp is None else cp * fd[:, k]
        prods.append(cp)
    g_k = g[:, None] * torch.stack(prods, dim=1)
    if not texel_grad:
        return g_k, None
    s, suffix = ctb[:, D - 1], [None] * D
    suffix[D - 1] = s
    for k in range(D - 2, -1, -1):
        s = ctb[:, k] + fd[:, k + 1] * s
        suffix[k] = s
    g_prev = torch.cat([g[:, None], g_k[:, :-1]], dim=1)
    d_f = torch.where((dcode != 0)[..., None],
                      g_prev * torch.stack(suffix, dim=1), 0.0)
    (d_images,) = torch.autograd.grad(f, images, grad_outputs=d_f)
    return g_k, d_images


def record_rows(ctb, abc, dcode) -> torch.Tensor:
    """The records as one (n, D, 8) float32 buffer: the rows K6a's
    `sphere_kernel` wrote, when ctb, abc and dcode are its views; else a
    packed copy (the records of `render_kernel` and `media_kernel`)."""
    n, D = dcode.shape
    st = (D * mk.RECORD_COLS, mk.RECORD_COLS)
    o = ctb.storage_offset()
    ctb, abc = ctb.detach(), abc.detach()
    storage = ctb.untyped_storage()
    if (ctb.dtype == abc.dtype == torch.float32
            and dcode.dtype == torch.int32
            and ctb.stride() == (*st, 1) and abc.stride() == (*st, 1)
            and dcode.stride() == st
            and abc.untyped_storage().data_ptr() == storage.data_ptr()
            and dcode.untyped_storage().data_ptr() == storage.data_ptr()
            and abc.storage_offset() == o + 3
            and dcode.storage_offset() == o + 6
            and storage.nbytes() >= 4 * (o + n * D * mk.RECORD_COLS)):
        return ctb.as_strided((n, D, mk.RECORD_COLS), (*st, 1), o)
    rows = torch.zeros((n, D, mk.RECORD_COLS), dtype=torch.float32,
                       device=dcode.device)
    rows[..., 0:3] = ctb
    rows[..., 3:6] = abc
    rows.view(torch.int32)[..., 6] = dcode
    return rows


def operands(textures: TextureTable, ctb, abc, dcode) -> dict:
    """Both kernels' operands, checked: the record rows, each texture's
    (image, height, width, 0) and the atlas (build it once to time a launch
    alone)."""
    device = dcode.device
    n, D = dcode.shape
    if n >= 2**31:
        raise ValueError("the records' lanes must fit in int32")
    rows = record_rows(ctb, abc, dcode)
    images = textures.images.detach()
    _check(rows, torch.float32, (n, D, mk.RECORD_COLS), device)
    _check(images, torch.float32, images.shape, device)
    if rows.data_ptr() % 16 or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError("the record rows must lie on a 16-byte boundary and "
                         "the atlas be (I, H, W, 3)")
    n_img, ph, pw = images.shape[:3]
    img = textures.image_id.long().clamp(0, n_img - 1)
    hw = textures.image_hw.to(device)[img].to(torch.int32)
    tex = torch.stack([img.to(torch.int32), hw[:, 0], hw[:, 1],
                       torch.zeros_like(hw[:, 0])], dim=1).contiguous()
    return dict(n=n, D=D, rows=rows, tex=tex, images=images, ph=ph, pw=pw)


def _launch_combine(ops, init=None, return_factors: bool = False):
    """One launch of the forward kernel on `operands` -> (rad, F or None)."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    n, device = ops["n"], ops["rows"].device
    if init is not None:
        init = tuple(x.detach().to(torch.float32).contiguous() for x in init)
        for x in init:
            _check(x, torch.float32, (n, 3), device)
    rad = torch.empty((n, 3), dtype=torch.float32, device=device)
    fac = (torch.empty((n, 3), dtype=torch.float32, device=device)
           if return_factors else None)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_combine_images(
            ops["rows"].data_ptr(), n, ops["D"], ops["tex"].data_ptr(),
            ops["images"].data_ptr(), ops["ph"], ops["pw"],
            *((None, None) if init is None else (x.data_ptr() for x in init)),
            rad.data_ptr(), None if fac is None else fac.data_ptr(), stream)
    _build.check(lib, err, "rtw_combine_images launch")
    return rad, fac


def _launch_vjp(ops, g, texel_grad: bool = True):
    """One launch of the VJP kernel on `operands` -> (g_k, d_images or
    None)."""
    from raytracer_weekend_tpu_torch.ops.cuda import _build

    n, D, device = ops["n"], ops["D"], ops["rows"].device
    g = g.detach().to(torch.float32).contiguous()
    _check(g, torch.float32, (n, 3), device)
    g_k = torch.empty((n, D, 3), dtype=torch.float32, device=device)
    d_images = torch.zeros_like(ops["images"]) if texel_grad else None
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtw_combine_images_vjp(
            ops["rows"].data_ptr(), n, D, ops["tex"].data_ptr(),
            ops["images"].data_ptr(), ops["ph"], ops["pw"], g.data_ptr(),
            g_k.data_ptr(), None if d_images is None else d_images.data_ptr(),
            stream)
    _build.check(lib, err, "rtw_combine_images_vjp launch")
    return g_k, d_images


def combine_images(textures: TextureTable, ctb, abc, dcode, *, init=None,
                   return_factors: bool = False):
    """rad (n, 3) of the image-only records, with `return_factors` (rad, F),
    continuing `init` = (rad, F) when given. The forward kernel on a card
    (counting its lanes x bounces in `combine_kernel_slots`), the plain
    version on the CPU."""
    global COMBINE_LAUNCHES
    if dcode.device.type == "cpu":
        return combine_images_reference(textures, ctb, abc, dcode, init=init,
                                        return_factors=return_factors)
    if dcode.device.type != "cuda":
        raise NotImplementedError(f"no image combine on {dcode.device}")
    ops = operands(textures, ctb, abc, dcode)
    rad, fac = _launch_combine(ops, init, return_factors)
    COMBINE_LAUNCHES += 1
    metrics.count("combine_kernel_slots", ops["n"] * ops["D"])
    return (rad, fac) if return_factors else rad


def combine_images_vjp(textures: TextureTable, ctb, abc, dcode, g, *,
                       texel_grad: bool = True):
    """(g_k (n, D, 3), the atlas's gradient, or None without `texel_grad`)
    of `combine_images` for the radiance cotangent g (n, 3). The VJP kernel
    on a card, the plain version on the CPU."""
    global COMBINE_VJP_LAUNCHES
    if dcode.device.type == "cpu":
        return combine_images_vjp_reference(textures, ctb, abc, dcode, g,
                                            texel_grad=texel_grad)
    if dcode.device.type != "cuda":
        raise NotImplementedError(f"no image combine VJP on {dcode.device}")
    out = _launch_vjp(operands(textures, ctb, abc, dcode), g, texel_grad)
    COMBINE_VJP_LAUNCHES += 1
    return out
