"""The port's sharded step (``parallel/dp.py``) against JAX's
``make_sharded_train_step`` on the CPU: the same state and cameras through
the JAX step on the conftest's virtual CPU devices and through the port's
step as real gloo ranks (``parallel/launch.py``; the 1x1 mesh in this
process), one spawn a mesh, every check of that mesh on its results.

The scene is ``tests/test_parallel.py``'s ``_setup`` (48x32, capacity
256, 64 points, B = 4, black background, SO3xR3) with anisotropic scales
and jittered SH bands: with isotropic scales a rotation changes nothing
and the quaternions' gradient is rounding noise, and a colour channel of
0 (a uint8 seed colour of 0) sits on the SH clamp's kink, where JAX
splits the gradient of a tie and torch does not. Gradients are read from the
first Adam moments (mu = (1 - b1) g from zero moments), as in
``test_torch_train_step.py``; parameters after the step are not compared
(eps = 1e-15 makes the first update lr * sign(g)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from qed_splatter_tpu.parallel.dp import make_sharded_train_step as jmake
from qed_splatter_tpu.parallel.mesh import make_mesh as jmesh
from qed_splatter_tpu_torch.engine.optim import B1
from qed_splatter_tpu_torch.models.bilateral_grid import total_variation_loss
from qed_splatter_tpu_torch.models.gaussians import FIELDS, GROUPS
from qed_splatter_tpu_torch.parallel import launch
from qed_splatter_tpu_torch.parallel.dp import local_rows, shard_state
from qed_splatter_tpu_torch.parallel.mesh import Mesh, backend_for
from test_parallel import B, H, W, _setup

SPAWN_TIMEOUT = 240.0
LOSS_TERMS = ("loss", "main_loss", "depth_loss", "camera_opt_regularizer",
              "psnr")
EXACT = ("gaussian_count", "tile_max_count", "tile_overflow",
         "nonfinite_grads")


def _adam_np(s):
    return {"count": np.asarray(s[0].count), "mu": np.asarray(s[0].mu),
            "nu": np.asarray(s[0].nu)}


def _state_np(js):
    """A JAX TrainState (global arrays) as the numpy dict that
    ``from_jax_train_state`` takes."""
    d = {
        "params": {f: np.asarray(getattr(js.params, f)) for f in FIELDS},
        "opt_state": {g: _adam_np(js.opt_state[g]) for g in GROUPS},
        "camera_opt": np.asarray(js.camera_opt),
        "camera_opt_state": _adam_np(js.camera_opt_state),
        "stats": {k: np.asarray(getattr(js.stats, k)) for k in (
            "grad_norm_sum", "vis_count", "max_radii_frac")},
        "step": int(js.step),
    }
    if js.bilateral_grids is not None:
        d["bilateral_grids"] = np.asarray(js.bilateral_grids)
        d["bilateral_grid_state"] = _adam_np(js.bilateral_grid_state)
    return d


def _case(grid=False):
    """(JAX cfg, optims, state, batch) of ``_setup``, reshaped as the
    module docstring says; with ``grid``, bilateral grids (random, so the
    TV term and its gradient are not zero) and a random background (on
    black, empty pixels sit on the grid's kinks)."""
    from qed_splatter_tpu.engine.train_step import init_train_state

    cfg, optims, state, batch = _setup()
    rng = np.random.default_rng(1)
    p = state.params
    p = p.replace(
        scales=p.scales + jnp.asarray(rng.normal(
            0, 0.4, p.scales.shape).astype(np.float32)),
        features_rest=jnp.asarray(rng.normal(
            0, 0.2, p.features_rest.shape).astype(np.float32)),
        features_dc=p.features_dc + jnp.asarray(rng.normal(
            0, 0.05, p.features_dc.shape).astype(np.float32)))
    if grid:
        cfg = dataclasses.replace(cfg, use_bilateral_grid=True,
                                  background_color="random")
        state = init_train_state(p, optims, num_cameras=B,
                                 use_bilateral_grid=True)
        g = np.asarray(state.bilateral_grids)
        state = state.replace(bilateral_grids=jnp.asarray(
            g + rng.normal(0, 0.05, g.shape).astype(np.float32)))
    else:
        state = state.replace(params=p)
    return cfg, optims, state, batch


def _port_cfg(jcfg, **kw):
    keep = ("background_color", "max_per_tile", "camera_opt_mode",
            "use_bilateral_grid")
    return {**{k: getattr(jcfg, k) for k in keep}, **kw}


def _jax_step(mesh_shape, grid=False, need_absgrad=True, seed=7):
    cfg, optims, state, batch = _case(grid)
    nd, nm = mesh_shape
    mesh = jmesh(nd, nm, devices=jax.devices()[:nd * nm])
    fn = jmake(cfg, optims, W, H, mesh, has_depth=True,
               need_absgrad=need_absgrad)
    rng = jax.random.PRNGKey(seed)
    state0 = _state_np(state)
    new, metrics = fn(state, batch, rng)
    bgs = np.stack([np.asarray(jax.random.uniform(k, (3,)))
                    for k in jax.random.split(rng, B)])
    want = {
        "mu": {g: np.asarray(new.opt_state[g][0].mu) for g in GROUPS},
        "camera_mu": np.asarray(new.camera_opt_state[0].mu),
        "grids_mu": (np.asarray(new.bilateral_grid_state[0].mu)
                     if grid else None),
        "stats": {k: np.asarray(getattr(new.stats, k)) for k in (
            "grad_norm_sum", "vis_count", "max_radii_frac")},
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    if grid:
        # the TV term in float64: XLA's float32 sum of JAX's is off it by
        # 1.1e-5 relative on these grids, torch's by 1e-8
        want["tv_f64"] = 10.0 * float(total_variation_loss(
            torch.tensor(state0["bilateral_grids"], dtype=torch.float64)))
    inp = {"state": state0,
           "batch": {k: np.asarray(v) for k, v in batch.items()},
           "cfg": _port_cfg(cfg), "need_absgrad": need_absgrad,
           "backgrounds": bgs if grid else None}
    return inp, want


def _run_port(mesh_shape, cases, tmp_path):
    inp, out = tmp_path / "cases.pt", tmp_path / "out.pt"
    torch.save(cases, inp)
    nd, nm = mesh_shape
    if nd * nm == 1:
        ranks.sharded_steps(str(inp), str(out), mesh_shape, W, H)
    else:
        launch.spawn(launch.run_rank, nd * nm, (
            ranks.one_thread, nd * nm, launch.free_port(),
            (ranks.sharded_steps, str(inp), str(out), mesh_shape, W, H)),
            timeout=SPAWN_TIMEOUT)
    return torch.load(out, weights_only=False)


def _close(got, want, name, bar=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < bar, f"{name}: max err {err:.2e} of max |value|"


def _hold(got, want, grid=False, need_absgrad=True):
    """Every check of one case: the bars of the module docstring."""
    gm, wm = got["metrics"], want["metrics"]
    assert set(gm) == set(wm)
    for k in LOSS_TERMS:
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=k)
    if grid:
        np.testing.assert_allclose(gm["tv_loss"], want["tv_f64"], rtol=1e-6)
    for k in EXACT:
        assert gm[k] == wm[k], (k, gm[k], wm[k])
    for g in GROUPS:
        _close(got["mu"][g] / (1 - B1), want["mu"][g] / (1 - B1), g)
        assert got["count"][g] == 1
    assert np.abs(want["mu"]["quats"]).max() > 0
    _close(got["camera_mu"], want["camera_mu"], "camera_opt")
    if grid:
        _close(got["grids_mu"] / (1 - B1), want["grids_mu"] / (1 - B1),
               "bilateral_grids")
    st, wst = got["stats"], want["stats"]
    np.testing.assert_array_equal(st["vis_count"], wst["vis_count"])
    np.testing.assert_array_equal(st["max_radii_frac"],
                                  wst["max_radii_frac"])
    if need_absgrad:
        assert wst["vis_count"].max() > 1      # several cameras see one
        _close(st["grad_norm_sum"], wst["grad_norm_sum"], "grad_norm_sum")
    else:
        assert not st["vis_count"].any() and not st["grad_norm_sum"].any()


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(mesh_shape, tmp_path):
    """One step at each mesh, on the kernel path's plain versions (the
    shared absgrad seed) and on the plain path (one ``tile_eps`` a
    camera); at 2x2 also with ``need_absgrad=False`` and with bilateral
    grids. Loss terms within 1e-5 relative (``tv_loss`` within 1e-6 of
    its float64 value, which JAX's float32 sum misses by 1.1e-5); each
    group's gradient, the camera's and the grids' within 1e-4 of each
    max; ``vis_count`` and
    ``max_radii_frac`` exact; ``grad_norm_sum`` within 1e-4 of max; the
    counts and maxima among the metrics exact."""
    inp, want = _jax_step(mesh_shape)
    cases = {"kernel_path": inp,
             "plain": dict(inp, cfg=dict(inp["cfg"], use_pallas=False))}
    extra = {}
    if mesh_shape == (2, 2):
        extra = {"no_absgrad": _jax_step(mesh_shape, need_absgrad=False),
                 "grid": _jax_step(mesh_shape, grid=True)}
        cases.update({k: v[0] for k, v in extra.items()})
    got = _run_port(mesh_shape, cases, tmp_path)
    cap = inp["state"]["params"]["means"].shape[0]
    for name in ("kernel_path", "plain"):
        assert got[name]["local_rows"] == cap // mesh_shape[1]
        assert got[name]["step"] == 1
        _hold(got[name], want)
    if extra:
        _hold(got["no_absgrad"], extra["no_absgrad"][1], need_absgrad=False)
        _hold(got["grid"], extra["grid"][1], grid=True)


def _fake_mesh(num_model, model_index):
    return Mesh(1, num_model, model_index, 0, model_index,
                torch.device("cpu"), "gloo", None, object(), None)


def test_shard_rows_and_capacity_check():
    """A leaf with the capacity's rows is split in contiguous blocks, the
    others are kept; a capacity that ``num_model`` does not divide raises
    naming both numbers."""
    from qed_splatter_tpu_torch.engine.train_step import from_jax_train_state

    cfg, optims, state, batch = _case()
    full = from_jax_train_state(_state_np(state), device="cpu")
    cap = full.params.capacity
    for m in range(2):
        part = shard_state(full, _fake_mesh(2, m))
        rows = slice(m * cap // 2, (m + 1) * cap // 2)
        assert local_rows(cap, _fake_mesh(2, m)) == rows
        assert torch.equal(part.params.means, full.params.means[rows])
        assert torch.equal(part.params.alive, full.params.alive[rows])
        assert torch.equal(part.opt_state["quats"]["nu"],
                           full.opt_state["quats"]["nu"][rows])
        assert torch.equal(part.stats.vis_count, full.stats.vis_count[rows])
        assert part.camera_opt is full.camera_opt
        assert part.opt_state["means"]["count"] is \
            full.opt_state["means"]["count"]
    with pytest.raises(ValueError, match=f"capacity {cap} .* "
                                         "num_model_shards 3"):
        shard_state(full, _fake_mesh(3, 0))


@pytest.mark.parametrize("cards,local_world,device,want", [
    (1, 4, "cuda", "gloo"), (4, 4, "cuda", "nccl"), (8, 4, "cuda", "nccl"),
    (2, 4, "cuda", "gloo"), (0, 2, "cpu", "gloo")])
def test_backend_follows_the_layout(monkeypatch, cards, local_world, device,
                                    want):
    """nccl only when every rank on the host has a card of its own; gloo
    for ranks that share a card (the H100 machine's one) and on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    assert backend_for(torch.device(device)) == want
