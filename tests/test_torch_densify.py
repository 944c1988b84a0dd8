"""Densification in the port against the JAX package on the CPU: ``refine``
(split, dup, cull, saturated and partial capacity, after a reset, after
densification, three split samples) from the same state and the same split
offsets, the opacity reset on and off its step, and capacity growth."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.configs import ModelConfig as JConfig
from qed_splatter_tpu.configs import default_optimizers as jdefault
from qed_splatter_tpu.engine.densify import DensifyStats as JStats
from qed_splatter_tpu.engine.densify import maybe_reset_opacities as jreset
from qed_splatter_tpu.engine.densify import refine as jrefine
from qed_splatter_tpu.engine.optim import GroupOptimizers as JOptims
from qed_splatter_tpu.engine.optim import replace_adam_moments
from qed_splatter_tpu.engine.train_step import init_train_state as jinit
from qed_splatter_tpu.engine.trainer import Trainer as JTrainer
from qed_splatter_tpu.models.gaussians import init_random as jinit_random
from qed_splatter_tpu_torch.configs import ModelConfig as TConfig
from qed_splatter_tpu_torch.configs import default_optimizers
from qed_splatter_tpu_torch.engine.densify import maybe_reset_opacities, \
    refine
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import from_jax_train_state, \
    make_train_step
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.models.gaussians import FIELDS, GROUPS
from qed_splatter_tpu_torch.testing import orbit_c2w_opengl

CAP = 256


def _jax_state(n_alive, seed, all_alive=False, grad=1.0):
    """A JAX TrainState with random parameters (scales from needle-small to
    world-big, opacities around the cull threshold; all opaque when every
    slot is alive), random statistics and dirty Adam moments."""
    rng = np.random.default_rng(seed)
    p = jinit_random(num_points=n_alive, capacity=CAP, seed=seed)
    alive = np.ones(CAP, bool) if all_alive else np.asarray(p.alive)
    p = p.replace(
        alive=jnp.asarray(alive),
        means=jnp.asarray(rng.normal(0, 1, (CAP, 3)).astype(np.float32)),
        scales=jnp.asarray(rng.uniform(np.log(1e-3), np.log(0.8), (CAP, 3))
                           .astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (CAP, 4)).astype(np.float32)),
        opacities=jnp.asarray(np.full(CAP, 2.0, np.float32) if all_alive
                              else rng.normal(-2.0, 3.0, CAP).astype(
                                  np.float32)),
        features_rest=jnp.asarray(rng.normal(
            0, 0.3, p.features_rest.shape).astype(np.float32)),
    )
    js = jinit(p, JOptims(jdefault()), num_cameras=2)
    opt = {}
    for g, s in js.opt_state.items():
        shape = getattr(p, g).shape
        opt[g] = replace_adam_moments(
            s, jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
            jnp.asarray(rng.uniform(0.1, 1, shape).astype(np.float32)))
    stats = JStats(
        grad_norm_sum=jnp.asarray((grad * rng.exponential(0.05, CAP))
                                  .astype(np.float32)),
        vis_count=jnp.asarray(rng.integers(0, 4, CAP).astype(np.float32)),
        max_radii_frac=jnp.asarray(rng.uniform(0, 0.25, CAP)
                                   .astype(np.float32)),
    )
    return js.replace(opt_state=opt, stats=stats)


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


# (name, alive, step, cfg overrides, all slots alive, grad scale)
CASES = [
    ("mixed", 120, 2500, {}, False, 1.0),
    ("saturated", 256, 2500, {}, True, 10.0),
    ("partial", 240, 2500, {}, False, 1.0),
    ("after_reset", 120, 3050, {}, False, 1.0),
    ("post_densification", 120, 16_050, {}, False, 1.0),
    ("no_screen_split", 120, 4500, {}, False, 1.0),
    ("three_samples", 100, 2500, dict(n_split_samples=3), False, 1.0),
    ("no_post_cull", 120, 16_050,
     dict(continue_cull_post_densification=False), False, 1.0),
]


@pytest.mark.parametrize("name,n_alive,step,over,all_alive,grad", CASES,
                         ids=[c[0] for c in CASES])
def test_refine_matches_jax(name, n_alive, step, over, all_alive, grad):
    """Alive sets and RefineInfo exact, parameters and moments within 1e-6,
    from one state and the split offsets JAX draws."""
    js = _jax_state(n_alive, seed=len(name), all_alive=all_alive, grad=grad)
    jcfg = dataclasses.replace(JConfig(), **over)
    key = jax.random.PRNGKey(7)
    jp, jopt, jstats, jinfo = jrefine(
        js.params, js.opt_state, js.stats, jnp.asarray(step, jnp.int32), key,
        jcfg, num_train_data=10, max_hw=100)
    eps = np.array(jax.random.normal(key, (CAP, 3)))

    ts = from_jax_train_state(_to_numpy(js), device="cpu")
    tcfg = dataclasses.replace(TConfig(), **over)
    tp, topt, tstats, tinfo = refine(
        ts.params, ts.opt_state, ts.stats, step, tcfg, num_train_data=10,
        max_hw=100, eps=torch.as_tensor(eps))

    assert tinfo._asdict() == {k: int(v) for k, v in
                               jinfo._asdict().items()}
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    for f in GROUPS:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-6,
                                   rtol=0, err_msg=f)
        np.testing.assert_allclose(topt[f]["mu"].numpy(),
                                   np.asarray(jopt[f][0].mu), atol=1e-6,
                                   err_msg=f)
        np.testing.assert_allclose(topt[f]["nu"].numpy(),
                                   np.asarray(jopt[f][0].nu), atol=1e-6,
                                   err_msg=f)
    for k in ("grad_norm_sum", "vis_count", "max_radii_frac"):
        assert not getattr(tstats, k).any()
    # the inputs are not modified
    np.testing.assert_array_equal(ts.params.alive.numpy(),
                                  np.asarray(js.params.alive))
    if name == "mixed":
        assert tinfo.n_split > 0 and tinfo.n_dup > 0 and tinfo.n_culled > 0
    if name == "saturated":
        # no free slot: no densification, and no net loss
        assert tinfo.n_split == tinfo.n_dup == tinfo.n_dropped == 0
        assert tinfo.n_alive == CAP
    if name == "partial":
        assert 0 < tinfo.n_split + tinfo.n_dup
    if name == "after_reset":
        assert tinfo.n_split == tinfo.n_dup == tinfo.n_culled == 0


def test_refine_draws_offsets_from_a_generator():
    js = _jax_state(120, seed=3)
    ts = from_jax_train_state(_to_numpy(js), device="cpu")
    cfg = TConfig()

    def run(seed):
        return refine(ts.params, ts.opt_state, ts.stats, 2500, cfg, 10, 100,
                      generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.means, b.means)
    assert not torch.equal(a.means, c.means)
    assert torch.equal(a.alive, c.alive)


@pytest.mark.parametrize("step", [100, 101, 3100, 15_100],
                         ids=["reset", "off_step", "second_reset",
                              "after_densification"])
def test_reset_opacities_matches_jax(step):
    js = _jax_state(120, seed=5)
    jp, jopt = jreset(js.params, js.opt_state, jnp.asarray(step), JConfig())
    ts = from_jax_train_state(_to_numpy(js), device="cpu")
    tp, topt = maybe_reset_opacities(ts.params, ts.opt_state, step,
                                     TConfig())
    np.testing.assert_array_equal(tp.opacities.numpy(),
                                  np.asarray(jp.opacities))
    for g in GROUPS:
        np.testing.assert_array_equal(topt[g]["mu"].numpy(),
                                      np.asarray(jopt[g][0].mu))
        np.testing.assert_array_equal(topt[g]["nu"].numpy(),
                                      np.asarray(jopt[g][0].nu))
    reset = step in (100, 3100)
    assert (tp is not ts.params) == reset
    assert bool((topt["opacities"]["mu"] == 0).all()) == reset


def test_grow_capacity_matches_jax_and_trains():
    """The grown state equals JAX's ``_grown_state`` (unit quaternions in
    the new slots, zero moments and stats), the old tensors are untouched,
    and one step on the grown state has finite gradients."""
    js = _jax_state(120, seed=9)
    jg = JTrainer._grown_state(js, 2 * CAP)
    ts = from_jax_train_state(_to_numpy(js), device="cpu")
    before = ts.params.quats.clone()
    tg = Trainer._grown_state(ts, 2 * CAP)
    want = _to_numpy(jg)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tg.params, f).numpy(),
                                      want["params"][f], err_msg=f)
    for g in GROUPS:
        for k in ("count", "mu", "nu"):
            np.testing.assert_array_equal(tg.opt_state[g][k].numpy(),
                                          want["opt_state"][g][k])
    for k, v in want["stats"].items():
        np.testing.assert_array_equal(getattr(tg.stats, k).numpy(), v)
    assert torch.equal(ts.params.quats, before)
    assert (tg.params.quats[CAP:] == torch.tensor([1.0, 0, 0, 0])).all()
    assert not tg.params.alive[CAP:].any()

    w, h = 48, 32
    K = np.array([[40, 0, w / 2], [0, 40, h / 2], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    tg.params.means[:CAP, 2] += 3.0
    batch = dict(c2w=orbit_c2w_opengl(3.0, 0.2, 0.1, (0, 0, 3.0)), K=K,
                 cam_idx=0, rgb=rng.uniform(0, 1, (h, w, 3)).astype(
                     np.float32),
                 depth=rng.uniform(1, 4, (h, w, 1)).astype(np.float32))
    step = make_train_step(TConfig(max_per_tile=128,
                                   background_color="black"),
                           GroupOptimizers(default_optimizers()), w, h,
                           has_depth=True, device="cpu")
    sg = step.grads(tg, batch, None)
    for name, g in sg.params.items():
        assert torch.isfinite(g).all(), name
    assert float(sg.params["means"].abs().max()) > 0
