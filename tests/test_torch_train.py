"""The port's inverse renderer against the JAX package's.

`train.InverseRenderer` on the CPU (staged torch path under autograd, Adam)
against JAX `InverseRenderer` with rmesh=None (staged path under jax.grad,
optax Adam): three steps from color1 + 0.2 on two_spheres at 16x12, 2 spp,
depth 4, the setting of tests/test_fused_diff.py:81-101.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_weekend_tpu.config import RenderConfig as JConfig
from raytracer_weekend_tpu.models import scenes as JS
from raytracer_weekend_tpu.scene import builder as JB
from raytracer_weekend_tpu.train import InverseRenderer as JInverseRenderer
from raytracer_weekend_tpu_torch import integrator as TI
from raytracer_weekend_tpu_torch import train
from raytracer_weekend_tpu_torch.config import RenderConfig as TConfig
from raytracer_weekend_tpu_torch.models import scenes as TS
from raytracer_weekend_tpu_torch.ops.cuda import megakernel as mk
from raytracer_weekend_tpu_torch.ops.cuda import replay_bwd as RB
from raytracer_weekend_tpu_torch.scene import builder as TB

SIZE = dict(width=16, height=12, samples_per_pixel=2, max_depth=4, seed=3)


def _setup():
    jc, tc = JConfig(use_pallas=False, **SIZE), TConfig(**SIZE)
    objs, jcams, bg = JS.two_spheres(jc.aspect_ratio, seed=0)
    js, jst = JB.build_scene(objs, background=bg, seed=jc.seed)
    objs, tcams, bg = TS.two_spheres(tc.aspect_ratio, seed=0)
    ts, tst = TB.build_scene(objs, background=bg, seed=tc.seed)
    target = TI.render_image(ts, tst, tc, tcams[0]) / tc.samples_per_pixel
    return (js, jst, jc, jcams[0]), (ts, tst, tc, tcams[0]), target.numpy()


def test_inverse_renderer_matches_jax():
    """(e) Loss histories to rtol 1e-3, updated colors to atol 1e-4."""
    (js, jst, jc, jcam), (ts, tst, tc, tcam), target = _setup()
    jstart = js._replace(textures=js.textures._replace(
        color1=js.textures.color1 + 0.2))
    tstart = ts._replace(textures=ts.textures._replace(
        color1=ts.textures.color1 + 0.2))
    jfit, jhist = JInverseRenderer(jst, jc, jcam, jnp.asarray(target)).fit(
        jstart, steps=3)
    seen = []
    launches = RB.LAUNCHES, mk.LAUNCHES, mk.EMIT_LAUNCHES
    tfit, thist = train.InverseRenderer(tst, tc, tcam,
                                        torch.from_numpy(target)).fit(
        tstart, steps=3, callback=lambda i, loss, sc: seen.append((i, loss)))
    assert (RB.LAUNCHES, mk.LAUNCHES, mk.EMIT_LAUNCHES) == launches
    assert [i for i, _ in seen] == [0, 1, 2]
    assert [loss for _, loss in seen] == thist
    np.testing.assert_allclose(thist, jhist, rtol=1e-3)
    assert thist[-1] < thist[0]
    for f in ("color1", "color2"):
        np.testing.assert_allclose(getattr(tfit.textures, f).numpy(),
                                   np.asarray(getattr(jfit.textures, f)),
                                   rtol=0, atol=1e-4)
    # The scene passed in is untouched, integer leaves stay as they were.
    assert torch.equal(tstart.textures.color1, ts.textures.color1 + 0.2)
    assert torch.equal(tfit.spheres.mat, ts.spheres.mat)
    assert not tfit.textures.color1.requires_grad


def test_inverse_renderer_custom_loss_and_rmesh():
    (_, _, _, _), (ts, tst, tc, tcam), target = _setup()
    ir = train.InverseRenderer(tst, tc, tcam, torch.from_numpy(target),
                               loss_fn=lambda img, tgt: (img - tgt).abs().sum())
    want = float((ir._render(ts) - ir.target).abs().sum())
    assert float(ir.loss(ts)) == pytest.approx(want)
    # A mesh of one rank (no process group): the sharded render gives the
    # same loss and gradients as the single-device render.
    from raytracer_weekend_tpu_torch.parallel.mesh import make_render_mesh

    irm = train.InverseRenderer(tst, tc, tcam, torch.from_numpy(target),
                                rmesh=make_render_mesh((1, 1, 1), "cpu"),
                                loss_fn=ir.loss_fn)
    assert float(irm.loss(ts)) == pytest.approx(want)
    (loss, grads), (mloss, mgrads) = ir.value_and_grad(ts), \
        irm.value_and_grad(ts)
    assert mloss == pytest.approx(loss)
    for g, mg in zip(grads, mgrads):
        torch.testing.assert_close(mg, g, rtol=1e-6, atol=1e-7)
