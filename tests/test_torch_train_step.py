"""The whole training step, port vs the JAX package on the CPU: one step
of ``make_train_step`` from the same state (carried across with
``from_jax_train_state``), a short fit whose loss falls, the random
background, and the refusal of what the port does not have yet.

The gradients are read from the first Adam moments: from zero moments one
step leaves mu = (1 - b1) g exactly as rounded on each side, so comparing
mu compares the sanitized gradients. Parameters after the step are not
compared: with eps = 1e-15 the first Adam update is lr * sign(g), so a
gradient near 0 whose rounding differs flips a whole lr."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.configs import ModelConfig as JConfig
from qed_splatter_tpu.configs import default_optimizers as jdefault
from qed_splatter_tpu.engine.optim import GroupOptimizers as JOptims
from qed_splatter_tpu.engine.train_step import init_train_state as jinit
from qed_splatter_tpu.engine.train_step import make_train_step as jmake
from qed_splatter_tpu.models.gaussians import init_from_points
from qed_splatter_tpu.testing import orbit_c2w_opengl
from qed_splatter_tpu_torch.configs import ModelConfig as TConfig
from qed_splatter_tpu_torch.configs import default_optimizers
from qed_splatter_tpu_torch.engine.optim import B1, GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import (
    from_jax_train_state,
    init_train_state,
    make_train_step,
)
from qed_splatter_tpu_torch.models.gaussians import FIELDS, GROUPS
from qed_splatter_tpu_torch.models.gaussians import init_from_points as \
    tinit_points
from qed_splatter_tpu_torch.models.splatfacto import render as trender

W, H = 64, 48
STEP = 2500          # SH degree 2 active: features_rest gets gradients


def _jax_state(n=300, capacity=512, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.6 + 3.0
    rgb = (rng.uniform(0, 1, (n, 3)) * 255).astype(np.uint8)
    p = init_from_points(pts, rgb, capacity=capacity, seed=seed)
    p = p.replace(
        features_rest=jnp.asarray(rng.normal(
            0, 0.2, p.features_rest.shape).astype(np.float32)),
        opacities=jnp.asarray(rng.normal(0, 1.5, capacity).astype(
            np.float32)),
        # anisotropic, or the rotation has no effect and quats get no
        # gradient
        scales=p.scales + jnp.asarray(rng.normal(
            0, 0.4, (capacity, 3)).astype(np.float32)),
    )
    optims = JOptims(jdefault())
    js = jinit(p, optims, num_cameras=2)
    cam = rng.normal(0, 0.01, (2, 6)).astype(np.float32)
    js = js.replace(camera_opt=jnp.asarray(cam),
                    step=jnp.asarray(STEP, jnp.int32))
    return js, optims


def _to_numpy(js):
    def adam(s):
        return {"count": np.asarray(s[0].count), "mu": np.asarray(s[0].mu),
                "nu": np.asarray(s[0].nu)}

    return {
        "params": {f: np.asarray(getattr(js.params, f)) for f in FIELDS},
        "opt_state": {g: adam(js.opt_state[g]) for g in GROUPS},
        "camera_opt": np.asarray(js.camera_opt),
        "camera_opt_state": adam(js.camera_opt_state),
        "stats": {k: np.asarray(getattr(js.stats, k)) for k in (
            "grad_norm_sum", "vis_count", "max_radii_frac")},
        "step": int(js.step),
    }


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    f = 0.8 * max(W, H)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return dict(c2w=orbit_c2w_opengl(3.0, 0.3, 0.1, (0, 0, 3.0)), K=K,
                cam_idx=1,
                rgb=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                depth=rng.uniform(0.5, 4.0, (H, W, 1)).astype(np.float32))


def _grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < 1e-4, f"{name}: max err {err:.2e} of max |grad|"


@pytest.fixture(scope="module")
def jax_step():
    js, optims = _jax_state()
    batch = _batch()
    cfg = JConfig(use_pallas=False, background_color="black",
                  max_per_tile=128)
    step = jmake(cfg, optims, W, H, has_depth=True)
    state0 = _to_numpy(js)
    jb = {k: (jnp.asarray(v) if k != "cam_idx" else jnp.asarray(v, jnp.int32))
          for k, v in batch.items()}
    new, metrics = step(js, jb, jax.random.PRNGKey(0))
    return state0, batch, _to_numpy(new), {k: np.asarray(v) for k, v in
                                          metrics.items()}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel_path"])
def test_train_step_matches_jax(jax_step, use_pallas):
    """Loss, metrics, every group's gradient, the camera gradient and the
    stats of one step. Tolerance 1e-4 of each gradient's max |value| (the
    sums run in other orders; index_add_ on the gather); 1e-5 relative on
    the loss terms."""
    state0, batch, want, jmetrics = jax_step
    cfg = TConfig(use_pallas=use_pallas, background_color="black",
                  max_per_tile=128)
    state = from_jax_train_state(state0, device="cpu")
    step = make_train_step(cfg, GroupOptimizers(default_optimizers()), W, H,
                           has_depth=True, device="cpu")
    new, metrics = step(state, batch, None)
    assert new.step == STEP + 1
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "main_loss", "depth_loss", "camera_opt_regularizer",
              "psnr"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k],
                                   rtol=1e-5, err_msg=k)
    for k in ("nonfinite_grads", "gaussian_count", "tile_overflow",
              "bbox_truncated", "tile_max_count"):
        assert float(metrics[k]) == float(jmetrics[k]), k
    for g in GROUPS:
        _grad_close(new.opt_state[g]["mu"].numpy() / (1 - B1),
                    want["opt_state"][g]["mu"] / (1 - B1), g)
        assert int(new.opt_state[g]["count"]) == 1
    _grad_close(new.camera_opt_state["mu"].numpy(),
                want["camera_opt_state"]["mu"], "camera_opt")
    assert np.abs(want["opt_state"]["features_rest"]["mu"]).max() > 0
    np.testing.assert_array_equal(new.stats.vis_count.numpy(),
                                  want["stats"]["vis_count"])
    np.testing.assert_array_equal(new.stats.max_radii_frac.numpy(),
                                  want["stats"]["max_radii_frac"])
    _grad_close(new.stats.grad_norm_sum.numpy(),
                want["stats"]["grad_norm_sum"], "absgrad stats")


def _teacher_targets(w, h, cams, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (200, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    rgb = (rng.uniform(0, 1, (200, 3)) * 255).astype(np.uint8)
    teacher = tinit_points(pts, rgb, capacity=256, init_opacity=0.8,
                           device="cpu")
    teacher = teacher.replace(scales=teacher.scales + 0.5)
    cfg = TConfig(max_per_tile=128, sh_degree=0)
    out = []
    for c2w, K in cams:
        o = trender(teacher, c2w, K, w, h, cfg, device="cpu")
        out.append((o.rgb, o.depth))
    return pts, out


def test_train_step_fit_loss_falls():
    """60 steps of a student from jittered teacher points on 3 cameras at
    48x32 through the kernel path's plain versions: the loss falls and
    everything stays finite."""
    w, h = 48, 32
    f = 0.8 * max(w, h)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    cams = [(orbit_c2w_opengl(3.0, a, 0.1, (0, 0, 3.0)), K)
            for a in (-0.3, 0.0, 0.3)]
    pts, targets = _teacher_targets(w, h, cams)
    rng = np.random.default_rng(4)
    student = tinit_points(pts + rng.normal(0, 0.05, pts.shape).astype(
        np.float32), None, capacity=256, device="cpu")
    cfg = TConfig(max_per_tile=128, sh_degree=0, background_color="random")
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(student, optims, num_cameras=3)
    step = make_train_step(cfg, optims, w, h, has_depth=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(60):
        c = i % 3
        state, m = step(state, dict(c2w=cams[c][0], K=K, cam_idx=c,
                                    rgb=targets[c][0], depth=targets[c][1]),
                        gen)
        losses.append(float(m["loss"]))
        assert float(m["nonfinite_grads"]) == 0.0
    assert np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < 0.6 * np.mean(losses[:3]), losses
    assert float(state.stats.vis_count.max()) > 0
    assert float(state.stats.grad_norm_sum.max()) > 0
    for name in GROUPS:
        assert torch.isfinite(getattr(state.params, name)).all(), name


def test_random_background_reproducible():
    """The random training background: shape [3], in [0, 1), the same from
    the same seed, another from another seed; no generator is refused."""
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(
        np.float32)
    pts[:, 2] += 3.0
    params = tinit_points(pts, None, capacity=128, device="cpu")
    c2w = orbit_c2w_opengl(3.0, 0.0, 0.0, (0, 0, 3.0))
    K = np.array([[30, 0, 16], [0, 30, 16], [0, 0, 1]], np.float32)
    cfg = TConfig(max_per_tile=64, background_color="random")

    def bg(seed):
        out = trender(params, c2w, K, 32, 32, cfg, train=True, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
        return out.background, out.rgb

    a, rgb_a = bg(1)
    b, rgb_b = bg(1)
    c, _ = bg(2)
    assert a.shape == (3,) and bool(((a >= 0) & (a < 1)).all())
    assert torch.equal(a, b) and torch.equal(rgb_a, rgb_b)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        trender(params, c2w, K, 32, 32, cfg, train=True, device="cpu")


@pytest.mark.parametrize("what", ["mixed_precision", "use_bilateral_grid"])
def test_train_step_refuses_unported(what):
    cfg = dataclasses.replace(TConfig(), **{what: True})
    optims = GroupOptimizers(default_optimizers())
    if what == "mixed_precision":
        # ported since (the bf16 operand kernels): the step builds;
        # tests/test_torch_mixed_precision.py runs it
        step = make_train_step(cfg, optims, 32, 32, has_depth=True,
                               device="cpu")
        assert step.cfg.mixed_precision
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(cfg, optims, 32, 32, has_depth=True, device="cpu")
    if what == "use_bilateral_grid":
        pts = np.zeros((4, 3), np.float32)
        pts[:, 0] = np.arange(4)
        params = tinit_points(pts, None, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            init_train_state(params, optims, 1, use_bilateral_grid=True)
