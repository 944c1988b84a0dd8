"""The bilateral grid of the port against the JAX package on the CPU: the
slice-and-apply at image sizes above, at and below the grid's (where
``jax.image.resize`` low-pass filters and the port takes the resize's own
weights), its gradients against ``jax.grad``, the TV loss, one training step
with the grid against JAX's step, the eager runner with the grid against
the per-step loop, a checkpoint round trip and a short trainer run."""

import dataclasses
import json

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
from qed_splatter_tpu.models import bilateral_grid as jbg
from qed_splatter_tpu.models.gaussians import init_from_points
from qed_splatter_tpu.testing import orbit_c2w_opengl
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig, default_optimizers
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine import scan_runner
from qed_splatter_tpu_torch.engine.optim import B1, GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import (
    from_jax_train_state,
    make_train_step,
)
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.models import bilateral_grid as tbg
from qed_splatter_tpu_torch.models.gaussians import FIELDS, GROUPS

W, H = 64, 48
STEP = 1200          # past the grid group's warm-up: a full learning rate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread (no oversubscription beside
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(seed=0, shape=(16, 16, 8)):
    rng = np.random.default_rng(seed)
    ident = np.asarray(jbg.init_bilateral_grids(1, shape))[0]
    return (ident + rng.normal(0, 0.1, ident.shape)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(84, 130), (16, 16), (10, 12), (20, 8)])
def test_apply_matches_jax(h, w):
    """The corrected image within 2e-6 and both gradients (grid and image)
    within 1e-5 of their max |value|, above, at and below the grid's size
    (below it in one axis or both: the resize-weight form)."""
    rng = np.random.default_rng(h * 1000 + w)
    grid = _grid(h + w)
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    want, vjp = jax.vjp(jbg.apply_bilateral_grid, jnp.asarray(grid),
                        jnp.asarray(rgb))
    tg = torch.as_tensor(grid).requires_grad_(True)
    tr = torch.as_tensor(rgb).requires_grad_(True)
    got = tbg.apply_bilateral_grid(tg, tr)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-6)
    cot = rng.normal(0, 1, (h, w, 3)).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    (got * torch.as_tensor(cot)).sum().backward()
    for a, b, name in ((tg.grad, jg[0], "grid"), (tr.grad, jg[1], "rgb")):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err < 1e-5, (name, err)


def test_small_images_take_the_resize_weights(monkeypatch):
    """An image shorter than the grid in an axis never reaches
    ``grid_sample`` (which does not low-pass filter); one at least the
    grid's size does."""
    calls = []
    real = tbg._slice_sample
    monkeypatch.setattr(tbg, "_slice_sample",
                        lambda *a: calls.append(1) or real(*a))
    grid = torch.as_tensor(_grid())
    tbg.apply_bilateral_grid(grid, torch.rand(12, 10, 3))
    assert not calls
    tbg.apply_bilateral_grid(grid, torch.rand(16, 16, 3))
    assert calls
    # identity grids leave the image as it is
    ident = tbg.init_bilateral_grids(2)[1]
    rgb = torch.rand(20, 30, 3)
    torch.testing.assert_close(tbg.apply_bilateral_grid(ident, rgb), rgb,
                               rtol=0, atol=1e-6)


def test_total_variation_matches_jax():
    """TV of a batch of grids within 1e-5 relative (float32 means summed in
    another order)."""
    g = np.random.default_rng(1).normal(0, 1, (3, 16, 16, 8, 12)).astype(
        np.float32)
    np.testing.assert_allclose(
        float(tbg.total_variation_loss(torch.as_tensor(g))),
        float(jbg.total_variation_loss(jnp.asarray(g))), rtol=1e-5)


def _adam_np(s):
    return {"count": np.asarray(s[0].count), "mu": np.asarray(s[0].mu),
            "nu": np.asarray(s[0].nu)}


@pytest.fixture(scope="module")
def jax_grid_step():
    rng = np.random.default_rng(0)
    n, cap = 300, 512
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.6 + 3.0
    rgb = (rng.uniform(0, 1, (n, 3)) * 255).astype(np.uint8)
    p = init_from_points(pts, rgb, capacity=cap, seed=0)
    p = p.replace(
        # SH colours off the clamp at 0, where a channel of 0/255 would sit
        # on a kink (JAX splits a tie's gradient, torch passes it whole)
        features_rest=jnp.asarray(rng.normal(
            0, 0.2, p.features_rest.shape).astype(np.float32)),
        opacities=jnp.asarray(rng.normal(0, 1.5, cap).astype(np.float32)),
        scales=p.scales + jnp.asarray(rng.normal(
            0, 0.4, (cap, 3)).astype(np.float32)))
    optims = JOptims(jdefault())
    js = jinit(p, optims, num_cameras=2, use_bilateral_grid=True)
    grids = np.stack([_grid(5), _grid(6)])
    js = js.replace(bilateral_grids=jnp.asarray(grids),
                    camera_opt=jnp.asarray(rng.normal(0, 0.01, (2, 6)).astype(
                        np.float32)),
                    step=jnp.asarray(STEP, jnp.int32))
    state0 = {
        "params": {f: np.asarray(getattr(js.params, f)) for f in FIELDS},
        "opt_state": {g: _adam_np(js.opt_state[g]) for g in GROUPS},
        "camera_opt": np.asarray(js.camera_opt),
        "camera_opt_state": _adam_np(js.camera_opt_state),
        "stats": {k: np.asarray(getattr(js.stats, k)) for k in (
            "grad_norm_sum", "vis_count", "max_radii_frac")},
        "step": STEP,
        "bilateral_grids": grids,
        "bilateral_grid_state": _adam_np(js.bilateral_grid_state),
    }
    f = 0.8 * max(W, H)
    batch = dict(
        c2w=orbit_c2w_opengl(3.0, 0.3, 0.1, (0, 0, 3.0)),
        K=np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32),
        cam_idx=1,
        rgb=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        depth=rng.uniform(0.5, 4.0, (H, W, 1)).astype(np.float32))
    # a random background: on black, empty pixels sit on the grid's lowest
    # level and on the guidance clip, kinks where JAX's autodiff takes its
    # own tie conventions
    cfg = JConfig(use_pallas=False, background_color="random",
                  max_per_tile=128, use_bilateral_grid=True)
    step = jmake(cfg, optims, W, H, has_depth=True)
    jb = {k: (jnp.asarray(v) if k != "cam_idx" else jnp.asarray(v, jnp.int32))
          for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    new, metrics = step(js, jb, key)
    bg = np.asarray(jax.random.uniform(jax.random.split(key)[0], (3,)))
    want = {"background": bg,"mu": {g: np.asarray(new.opt_state[g][0].mu) for g in GROUPS},
            "camera_opt": np.asarray(new.camera_opt_state[0].mu),
            "grids": np.asarray(new.bilateral_grid_state[0].mu)}
    return state0, batch, want, {k: np.asarray(v) for k, v in
                                 metrics.items()}


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < 1e-4, f"{name}: max err {err:.2e} of max |grad|"


def test_train_step_with_grid_matches_jax(jax_grid_step):
    """One step with the grid (JAX's random background passed in): the
    loss terms (``tv_loss`` among them) within 1e-5 relative, every group's
    gradient, the camera's and the grids' within 1e-4 of max |grad| (read
    from the first Adam moments), the grids' Adam count 1."""
    state0, batch, want, jm = jax_grid_step
    new = from_jax_train_state(state0, device="cpu")
    cfg = ModelConfig(use_pallas=False, background_color="random",
                      max_per_tile=128, use_bilateral_grid=True)
    step = make_train_step(cfg, GroupOptimizers(default_optimizers()), W, H,
                           has_depth=True, device="cpu")
    inp = step.inputs(batch, torch.Generator().manual_seed(0), new.step)
    inp.background = torch.as_tensor(want["background"].copy())
    metrics = step.run(new, inp)
    # the port counts the values the clamp cuts; JAX has no such metric
    assert set(metrics) == set(jm) | {"bilagrid_clamped"}
    for k in ("loss", "main_loss", "depth_loss", "tv_loss", "psnr",
              "camera_opt_regularizer"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=1e-5,
                                   err_msg=k)
    for g in GROUPS:
        _grad_close(new.opt_state[g]["mu"].numpy() / (1 - B1),
                    want["mu"][g] / (1 - B1), g)
    _grad_close(new.camera_opt_state["mu"].numpy(), want["camera_opt"],
                "camera_opt")
    _grad_close(new.bilateral_grid_state["mu"].numpy() / (1 - B1),
                want["grids"] / (1 - B1), "bilateral_grids")
    assert int(new.bilateral_grid_state["count"]) == 1
    # the group's schedule reads its own count: 0 at the first update, in
    # the warm-up from lr 0, so the grids stay where they were (in JAX too)
    assert torch.equal(new.bilateral_grids,
                       torch.as_tensor(state0["bilateral_grids"]))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    ttesting.write_synthetic_dataset(root, num_frames=5, width=64, height=48,
                                     with_ply=True)
    return root


def _trainer(dataset, tmp_path, **kw):
    model = ModelConfig(camera_opt_mode="off", max_per_tile=64,
                        adaptive_max_per_tile=False, num_downscales=0,
                        warmup_length=10, refine_every=10, sh_degree=1,
                        use_bilateral_grid=True, background_color="random")
    base = dict(max_num_iterations=10, steps_per_eval_image=0,
                steps_per_eval_all_images=0, steps_per_save=10, log_every=10)
    base.update(kw)
    return Trainer(TrainerConfig(output_dir=str(tmp_path), model=model,
                                 data=DataConfig(data=str(dataset)), **base),
                   device="cpu")


def test_eager_runner_with_grid_bit_equal_to_per_step_loop(dataset,
                                                           tmp_path):
    """A chunk of the runner with the grid on equals the per-step loop on
    every state tensor (the grids and their moments are state tensors the
    runner binds), and keeps ``tv_loss`` per step."""
    t = _trainer(dataset, tmp_path)
    n = 3
    ds = t._device_dataset(1)
    perm = t._next_perm(n)
    runner = scan_runner.make_scan_steps(t.cfg, t.optims, ds, n,
                                         device="cpu")
    start = 30
    s0 = dataclasses.replace(t.state, step=start)
    bgs = t._backgrounds(start, n)
    a, metrics = runner(ckpt.copy_state(s0, "cpu"), perm, bgs)
    b = ckpt.copy_state(s0, "cpu")
    for i, p in enumerate(perm):
        batch = {"c2w": ds.data["c2w"][p], "K": ds.data["K"][p],
                 "cam_idx": int(ds.data["cam_idx"][p]),
                 "rgb": ds.data["rgb_u8"][p].numpy().astype(np.float32)
                 / 255.0, "depth": ds.data["depth"][p]}
        b, _ = runner.step(b, batch, t._generator(start + i, 0))
    ta, tb = scan_runner.state_tensors(a), scan_runner.state_tensors(b)
    assert len(ta) == 7 + 6 * 3 + 1 + 3 + 3 + 1 + 3
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert "tv_loss" in runner.names
    assert float(metrics[:, runner.names.index("tv_loss")].min()) >= 0.0


def test_grid_trains_and_checkpoints(dataset, tmp_path):
    """10 steps on the multi-step path: the grids leave identity, the
    metrics rows carry ``tv_loss``, and the checkpoint's grids and moments
    come back bit-equal with the metadata naming the grid."""
    t = _trainer(dataset, tmp_path, steps_per_dispatch=0)
    assert t._use_scan()
    ident = tbg.init_bilateral_grids(t.state.bilateral_grids.shape[0])
    assert torch.equal(t.state.bilateral_grids, ident)
    t.train()
    assert not torch.equal(t.state.bilateral_grids, ident)
    rows = [json.loads(x) for x in
            (t.run_dir / "metrics.jsonl").read_text().splitlines()]
    assert any("tv_loss" in r for r in rows if r.get("split") != "eval")
    run = t.run_dir / "ckpts"
    meta = ckpt.checkpoint_meta(run)
    assert meta["use_bilateral_grid"] is True
    assert meta["bilateral_grid_shape"] == [16, 16, 8]
    back = ckpt.load_state(run, device="cpu")
    assert torch.equal(back.bilateral_grids, t.state.bilateral_grids)
    for k in ("count", "mu", "nu"):
        assert torch.equal(back.bilateral_grid_state[k],
                           t.state.bilateral_grid_state[k])
    # a resume trains on from the restored grids
    t2 = _trainer(dataset, tmp_path, steps_per_dispatch=0,
                  load_dir=str(run), max_num_iterations=20)
    assert torch.equal(t2.state.bilateral_grids, back.bilateral_grids)
    t2.train()
    assert t2.state.step == 20
