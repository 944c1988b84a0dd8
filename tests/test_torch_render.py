"""The render slice: the port's ``render`` on the CPU against the JAX
package's ``render`` (its XLA path and its Pallas path in interpret mode),
at small sizes, SH degree 3, RGB+D, with a crop box; and the training
render."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.configs import ModelConfig as JConfig
from qed_splatter_tpu.models.crop import CropBox as JCrop
from qed_splatter_tpu.models.gaussians import init_from_points
from qed_splatter_tpu.models.splatfacto import render as jrender
from qed_splatter_tpu.testing import orbit_c2w_opengl
from qed_splatter_tpu_torch.configs import ModelConfig as TConfig
from qed_splatter_tpu_torch.models.crop import CropBox as TCrop
from qed_splatter_tpu_torch.models.crop import get_empty_outputs
from qed_splatter_tpu_torch.models.gaussians import FIELDS, from_jax_arrays
from qed_splatter_tpu_torch.models.splatfacto import EVAL_BACKGROUND
from qed_splatter_tpu_torch.models.splatfacto import render as trender

TOL = 1e-4


def _scene(n=1500, capacity=2048, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.7 + 3.0
    rgb = (rng.uniform(0, 1, (n, 3)) * 255).astype(np.uint8)
    p = init_from_points(pts, rgb, capacity=capacity, seed=seed)
    p = p.replace(
        features_rest=jnp.asarray(rng.normal(
            0, 0.2, p.features_rest.shape).astype(np.float32)),
        opacities=jnp.asarray(rng.normal(
            0, 1.5, capacity).astype(np.float32)),
    )
    return p, from_jax_arrays({f: np.asarray(getattr(p, f)) for f in FIELDS},
                              device="cpu")


def _camera(w, h, az):
    f = 0.8 * max(w, h)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    return orbit_c2w_opengl(3.0, az, 0.1, (0, 0, 3.0)), K


def _compare(jo, to):
    np.testing.assert_allclose(to.rgb.numpy(), np.asarray(jo.rgb), atol=TOL)
    np.testing.assert_allclose(to.accumulation.numpy(),
                               np.asarray(jo.accumulation), atol=TOL)
    jd = np.asarray(jo.depth)
    assert (np.abs(to.depth.numpy() - jd) <= TOL * np.abs(jd)).all()
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))
    for f in ("tile_overflow", "bbox_truncated", "tile_max_count"):
        assert int(getattr(to, f)) == int(getattr(jo, f)), f


@pytest.mark.parametrize("w,h,step,interpret,crop", [
    (64, 48, 2500, False, False),
    (61, 47, 2500, True, False),
    (64, 48, 1500, True, True),
])
def test_render_matches_jax(w, h, step, interpret, crop):
    jp, tp = _scene()
    c2w, K = _camera(w, h, 0.4)
    jcfg = JConfig(max_per_tile=128, pallas_interpret=interpret)
    tcfg = TConfig(max_per_tile=128)
    jcrop = JCrop(center=(0.2, 0.0, 3.0), size=(1.6, 1.4, 2.0),
                  rotation=(0.8, -0.6, 0, 0.6, 0.8, 0, 0, 0, 1)) if crop \
        else None
    tcrop = TCrop(jcrop.center, jcrop.size, jcrop.rotation) if crop else None
    jo = jrender(jp, jnp.asarray(c2w), jnp.asarray(K), w, h, jcfg,
                 jnp.asarray(step), False, crop_box=jcrop)
    to = trender(tp, c2w, K, w, h, tcfg, step=step, crop_box=tcrop,
                 device="cpu")
    assert to.rgb.shape == (h, w, 3) and to.depth.shape == (h, w, 1)
    _compare(jo, to)
    # the plain compositor over id lists gives the same frame
    plain = trender(tp, c2w, K, w, h, TConfig(max_per_tile=128,
                                                 use_pallas=False),
                    step=step, crop_box=tcrop, device="cpu")
    _compare(jo, plain)


def test_render_antialiased_black_background_matches_jax():
    jp, tp = _scene(n=600, capacity=1024, seed=3)
    c2w, K = _camera(64, 48, 1.9)
    jo = jrender(jp, jnp.asarray(c2w), jnp.asarray(K), 64, 48,
                 JConfig(max_per_tile=128, rasterize_mode="antialiased",
                         background_color="black", sh_degree_interval=1),
                 jnp.asarray(1), False)
    to = trender(tp, c2w, K, 64, 48,
                 TConfig(max_per_tile=128, rasterize_mode="antialiased",
                         background_color="black", sh_degree_interval=1),
                 step=1, device="cpu")
    _compare(jo, to)


def test_empty_crop_renders_background():
    _, tp = _scene(n=300, capacity=512)
    c2w, K = _camera(40, 24, 0.0)
    out = trender(tp, c2w, K, 40, 24, TConfig(), step=0,
                  crop_box=TCrop(center=(50.0, 50.0, 50.0), size=(1, 1, 1)),
                  device="cpu")
    bg = torch.tensor(EVAL_BACKGROUND)
    empty = get_empty_outputs(40, 24, bg)
    assert torch.equal(out.rgb, empty["rgb"])
    assert torch.equal(out.accumulation, empty["accumulation"])
    assert not out.visible.any()
    assert int(out.tile_max_count) == 0


def test_render_refuses_training():
    """``render(train=True)`` is the differentiable training render: it
    matches the JAX training render (XLA path, black background), its loss
    backpropagates to finite gradients, and ``mixed_precision`` (ported
    since it was refused here) takes the bf16 operand compositor in training
    only: within the bf16 envelope of the float32 render, and the eval
    render unchanged by it."""
    jp, tp = _scene(n=400, capacity=512, seed=2)
    c2w, K = _camera(48, 32, 0.7)
    jo = jrender(jp, jnp.asarray(c2w), jnp.asarray(K), 48, 32,
                 JConfig(max_per_tile=128, background_color="black"),
                 jnp.asarray(2500), True)
    leaves = {f: getattr(tp, f).clone().requires_grad_(True)
              for f in ("means", "opacities", "features_rest")}
    to = trender(tp.replace(**leaves), c2w, K, 48, 32,
                 TConfig(max_per_tile=128, background_color="black"),
                 step=2500, train=True, device="cpu")
    _compare(jo, dataclasses.replace(
        to, rgb=to.rgb.detach(), depth=to.depth.detach(),
        accumulation=to.accumulation.detach()))
    loss = to.rgb.mean() + to.depth.mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    cfg = TConfig(max_per_tile=128, background_color="black")
    mixed = dataclasses.replace(cfg, mixed_precision=True)
    mo = trender(tp, c2w, K, 48, 32, mixed, step=2500, train=True,
                 device="cpu")
    diff = float((mo.rgb - to.rgb.detach()).abs().max())
    assert 0.0 < diff <= 2e-2, diff
    eval_f32 = trender(tp, c2w, K, 48, 32, cfg, step=2500, device="cpu")
    eval_mixed = trender(tp, c2w, K, 48, 32, mixed, step=2500, device="cpu")
    assert torch.equal(eval_f32.rgb, eval_mixed.rgb)
