"""Losses, SSIM, the learning-rate schedules and the per-group Adam of the
port against the JAX package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qed_splatter_tpu.configs import AdamConfig as JAdam
from qed_splatter_tpu.configs import default_optimizers as jdefault
from qed_splatter_tpu.engine.optim import make_optimizer as jmake_optimizer
from qed_splatter_tpu.engine.optim import make_schedule as jschedule
from qed_splatter_tpu.models import splatfacto as jsf
from qed_splatter_tpu.models.gaussians import GaussianParams as JParams
from qed_splatter_tpu.ops import ssim as jssim
from qed_splatter_tpu_torch.configs import AdamConfig
from qed_splatter_tpu_torch.configs import default_optimizers
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers, adam_init
from qed_splatter_tpu_torch.engine.optim import adam_update
from qed_splatter_tpu_torch.engine.optim import make_schedule
from qed_splatter_tpu_torch.models import splatfacto as tsf
from qed_splatter_tpu_torch.models.gaussians import GaussianParams
from qed_splatter_tpu_torch.ops import ssim as tssim


def _images(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("form", ["band", "depthwise"])
def test_ssim_matches_jax(form):
    """Value and gradient of the port's band-matmul SSIM and its depthwise
    oracle against both JAX forms, within 1e-5."""
    a, b = _images(0)
    tfn = tssim.ssim if form == "band" else tssim._ssim_depthwise
    x = torch.tensor(a, requires_grad=True)
    v = tfn(x, torch.tensor(b))
    (g,) = torch.autograd.grad(v, [x])
    for jfn in (jssim.ssim, jssim._ssim_depthwise):
        jv, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(b)))(
            jnp.asarray(a))
        np.testing.assert_allclose(float(v.detach()), float(jv), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)


def _loss_cases():
    rng = np.random.default_rng(5)
    pred = rng.uniform(0.5, 3, (8, 10, 1)).astype(np.float32)
    gt = rng.uniform(0.5, 3, (8, 10, 1)).astype(np.float32)
    gt_bad = gt.copy()
    gt_bad[0, :4] = 0.0
    gt_bad[1, :3] = np.nan
    gt_bad[2, :2] = np.inf
    mask = (rng.uniform(size=(8, 10, 1)) > 0.4).astype(np.float32)
    return {
        "invalid_gt": (pred, gt_bad, None),
        "empty": (pred, np.zeros_like(gt), None),
        "pixel_mask": (pred, gt, mask),
    }


@pytest.mark.parametrize("case", ["invalid_gt", "empty", "pixel_mask"])
def test_depth_l1_loss_matches_jax(case):
    pred, gt, mask = _loss_cases()[case]
    want = jsf.depth_l1_loss(jnp.asarray(pred), jnp.asarray(gt),
                             None if mask is None else jnp.asarray(mask))
    got = tsf.depth_l1_loss(torch.tensor(pred), torch.tensor(gt),
                            None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if case == "empty":
        assert float(got) == 0.0


@pytest.mark.parametrize("case", ["perfect", "mix", "masked"])
def test_photometric_loss_matches_jax(case):
    a, b = _images(1, 24, 30)
    mask = None
    if case == "perfect":
        b = a
    elif case == "mix":
        a, b = np.zeros_like(a), np.ones_like(a)
    else:
        mask = (np.random.default_rng(2).uniform(size=(24, 30, 1))
                > 0.3).astype(np.float32)
    want = jsf.photometric_loss(jnp.asarray(a), jnp.asarray(b), 0.2,
                                None if mask is None else jnp.asarray(mask))
    got = tsf.photometric_loss(torch.tensor(a), torch.tensor(b), 0.2,
                               None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    if case == "perfect":
        assert abs(float(got)) < 1e-6


@pytest.mark.parametrize("aniso", [False, True])
def test_scale_regularization_matches_jax(aniso):
    rng = np.random.default_rng(3)
    n = 64
    scales = np.log(np.full((n, 3), 0.05, np.float32))
    if aniso:
        scales[:, 0] += rng.uniform(0, 4, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.2
    fields = dict(means=np.zeros((n, 3), np.float32),
                  quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
                  scales=scales, opacities=np.zeros(n, np.float32),
                  features_dc=np.zeros((n, 3), np.float32),
                  features_rest=np.zeros((n, 15, 3), np.float32),
                  alive=alive)
    want = jsf.scale_regularization(
        JParams(**{k: jnp.asarray(v) for k, v in fields.items()}), 10.0)
    got = tsf.scale_regularization(
        GaussianParams(**{k: torch.tensor(v) for k, v in fields.items()}),
        10.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert (float(got) > 0.0) == aniso


def _jcfg(cfg):
    return JAdam(**cfg.__dict__)


@pytest.mark.parametrize("group", ["means", "features_dc", "camera_opt",
                                   "bilateral_grid"])
def test_schedule_matches_jax(group):
    cfg = default_optimizers()[group]
    assert _jcfg(cfg) == jdefault()[group]
    steps = [0, 1, 2, 499, 999, 1000, 1001, 7000, 29_999, 30_000, 45_000]
    got = make_schedule(cfg)(torch.tensor(steps))
    want = jschedule(_jcfg(cfg))(jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("cfg", [
    AdamConfig(lr=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
    AdamConfig(lr=1e-4, lr_final=5e-7, max_steps=30, warmup_steps=2,
               lr_pre_warmup=0.0),
    AdamConfig(lr=5e-2, eps=1e-8),
], ids=["decay", "warmup", "constant"])
def test_adam_matches_optax(cfg):
    """Three updates on identical gradients: moments, count and parameters
    against optax's scale_by_adam + scale_by_learning_rate (rel 1e-6)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(50, 3)).astype(np.float32)
    grads = [rng.normal(size=(50, 3)).astype(np.float32) for _ in range(3)]
    grads[0][0] = 0.0                        # a zero gradient
    tx = jmake_optimizer(_jcfg(cfg))
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    opt = GroupOptimizers({"g": cfg})
    tp = torch.tensor(p0)
    ts = adam_init(tp)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tu = adam_update(torch.tensor(g), ts, cfg, opt.schedules["g"])
        tp.add_(tu)
        np.testing.assert_allclose(tu.numpy(), np.asarray(upd), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
        np.testing.assert_allclose(ts["mu"].numpy(), np.asarray(js[0].mu),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts["nu"].numpy(), np.asarray(js[0].nu),
                                   rtol=1e-6)
        assert int(ts["count"]) == int(js[0].count) == int(js[1].count)
