"""Multi-step dispatch of the port against the JAX package on the CPU: the
device dataset, the dispatch chunk and the scan choice, the camera queue,
the runner's stacked metrics against JAX's ``make_scan_steps``, and the
eager runner bit-equal to the per-step loop. (On CUDA the runner replays a
CUDA graph of the same body: ``tests/test_torch_cuda.py``.)

Parameters after a step are compared only through the first Adam moment
after one step: eps = 1e-15 makes a first Adam update lr * sign(g)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu import testing as jtesting
from qed_splatter_tpu.configs import DataConfig as JData
from qed_splatter_tpu.configs import ModelConfig as JModel
from qed_splatter_tpu.configs import TrainerConfig as JTrainerConfig
from qed_splatter_tpu.engine.scan_runner import make_scan_steps as \
    jmake_scan_steps
from qed_splatter_tpu.engine.trainer import Trainer as JTrainer
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.engine import scan_runner
from qed_splatter_tpu_torch.engine.checkpoint import copy_state
from qed_splatter_tpu_torch.engine.train_step import from_jax_train_state
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.models.gaussians import FIELDS, GROUPS
from qed_splatter_tpu_torch.models.splatfacto import background_color

MODEL_KW = dict(camera_opt_mode="off", max_per_tile=64, num_downscales=2,
                resolution_schedule=20, warmup_length=10, refine_every=10,
                init_capacity_headroom=1.2, sh_degree=1,
                background_color="black")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    jtesting.write_synthetic_dataset(root, num_frames=5, width=64,
                                     height=48, with_ply=True)
    return root


def _configs(dataset, tmp_path, model_kw=None, **kw):
    mk = {**MODEL_KW, **(model_kw or {})}
    base = dict(max_num_iterations=40, steps_per_eval_image=0,
                steps_per_eval_all_images=0, steps_per_save=10, log_every=10)
    base.update(kw)
    return (TrainerConfig(output_dir=str(tmp_path / "t"),
                          data=DataConfig(data=str(dataset)),
                          model=ModelConfig(**mk), **base),
            JTrainerConfig(output_dir=str(tmp_path / "j"),
                           data=JData(data=str(dataset)), model=JModel(**mk),
                           **base))


@pytest.fixture
def trainers(dataset, tmp_path):
    tcfg, jcfg = _configs(dataset, tmp_path)
    return Trainer(tcfg, device="cpu"), JTrainer(jcfg)


def _jax_state_numpy(js):
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


@pytest.mark.parametrize("d", [1, 2])
def test_device_dataset_equals_jax(trainers, d):
    """Every field, dtype and value of the bucket's frames on the device."""
    t, j = trainers
    got, want = t._device_dataset(d), j._device_dataset(d)
    assert (got.width, got.height) == (want.width, want.height)
    assert (got.has_depth, got.has_mask) == (want.has_depth, want.has_mask)
    assert set(got.data) == set(want.data)
    for k, v in want.data.items():
        v = np.asarray(v)
        assert got.data[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got.data[k].numpy(), v, err_msg=k)
    assert got.nbytes() == want.nbytes()


def test_dispatch_chunk_and_scan_choice_equal_jax(trainers):
    """``_dispatch_chunk`` and ``_use_scan`` over a grid of cadences,
    explicit chunks and cache budgets."""
    t, j = trainers
    grid = []
    for spd in (0, 1, 4):
        for cad in ((10, 10, 20, 40, 10, 20), (7, 14, 0, 28, 10, 20),
                    (50, 100, 200, 400, 10, 200), (3, 0, 0, 0, 1, 20),
                    (500, 1000, 0, 30000, 100, 3000),
                    (100, 500, 2000, 30000, 100, 3000)):
            for budget in (1 << 10, 4 << 30):
                grid.append((spd, cad, budget))
    seen = set()
    for spd, (ref, warm, save, total, log, res), budget in grid:
        for tr in (t, j):
            tr.config = dataclasses.replace(
                tr.config, steps_per_dispatch=spd, steps_per_save=save,
                max_num_iterations=total, log_every=log,
                max_device_cache_bytes=budget)
            tr.cfg = dataclasses.replace(tr.cfg, refine_every=ref,
                                         warmup_length=warm,
                                         resolution_schedule=res)
        got = (t._dispatch_chunk(), t._use_scan())
        assert got == (j._dispatch_chunk(), j._use_scan()), (spd, ref, warm)
        seen.add(got)
    assert {c for c, _ in seen} >= {1, 4, 10, 100}
    assert {u for _, u in seen} == {True, False}


def test_camera_queue_equals_jax(trainers):
    """The chunk perms from ``_reseed_sampling``'s queue equal the JAX
    ``_train_scan`` queue's (its inline draw, below), also after a reseed
    at another step."""
    t, j = trainers

    def jax_perm(n):   # qed_splatter_tpu/engine/trainer.py, _train_scan
        while len(j._queue) < n:
            j._queue.extend(j._np_rng.permutation(j.dm.num_train).tolist())
        perm = np.asarray(j._queue[:n], np.int32)
        j._queue = j._queue[n:]
        return perm.tolist()

    for n in (3, 4, 10, 1, 7):
        assert t._next_perm(n) == jax_perm(n)
    t.state = dataclasses.replace(t.state, step=130)
    j.state = j.state.replace(step=jnp.asarray(130, jnp.int32))
    t._reseed_sampling()
    j._reseed_sampling()
    perms = [t._next_perm(n) for n in (6, 6, 6)]
    assert perms == [jax_perm(n) for n in (6, 6, 6)]
    assert sorted(perms[0][:5]) == list(range(t.dm.num_train))


N_STEPS, D = 4, 2


@pytest.fixture(scope="module")
def jax_scan(dataset, tmp_path_factory):
    """JAX's ``make_scan_steps`` (XLA path) for one step and for four at 1/2
    res from one state, on a random perm: (port trainer, its dataset, the
    state as numpy, perm, {steps: (state, stacked metrics)})."""
    tcfg, jcfg = _configs(dataset, tmp_path_factory.mktemp("scan"))
    t, j = Trainer(tcfg, device="cpu"), JTrainer(jcfg)
    # anisotropic scales: with isotropic ones a rotation changes nothing
    # and the quats' gradient is rounding noise. Colours off the SH clamp's
    # kink: a black seed point sits exactly at clamp(dc + 0.5, min=0),
    # where JAX's maximum passes half the gradient and torch.clamp all.
    p = j.state.params
    rng = np.random.default_rng(5)

    def jitter(x, s):
        return x + jnp.asarray(rng.normal(0, s, x.shape).astype(np.float32))

    js = j.state.replace(params=p.replace(
        scales=jitter(p.scales, 0.4), features_dc=jitter(p.features_dc,
                                                         0.05)))
    state0 = _jax_state_numpy(js)
    perm = np.random.default_rng(3).permutation(t.dm.num_train)[:N_STEPS]
    jcfg = dataclasses.replace(j.cfg, use_pallas=False)
    want = {}
    for steps in (1, N_STEPS):
        run = jmake_scan_steps(jcfg, j.optims, j._device_dataset(D), steps)
        new, m = run(jax.tree.map(jnp.copy, js),
                     jnp.asarray(perm[:steps], jnp.int32),
                     jax.random.PRNGKey(0))
        want[steps] = (_jax_state_numpy(new),
                       {k: np.asarray(v) for k, v in m.items()})
    return t, t._device_dataset(D), state0, perm, want


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel_path"])
def test_runner_matches_jax_make_scan_steps(jax_scan, use_pallas):
    """Four steps at 1/2 res against JAX's ``make_scan_steps`` (XLA path)
    from one state: every stacked metric within the trainer parity tests'
    1e-5 relative (the counts exactly) on step 1, within 1e-3 relative on
    steps 2-4 (a first Adam step is lr * sign(g): where a gradient near 0
    rounds to the other sign a parameter moves by a whole lr); the camera
    read by each step; and every group's first moment after one step within
    1e-4 of its max |g|."""
    t, tds, state0, perm, want = jax_scan
    tcfg = dataclasses.replace(t.cfg, use_pallas=use_pallas)
    for steps in (1, N_STEPS):
        runner = scan_runner.make_scan_steps(tcfg, t.optims, tds, steps,
                                             device="cpu")
        state = from_jax_train_state(state0, device="cpu")
        new, metrics = runner(state, perm[:steps])
        assert new.step == state0["step"] + steps
        assert int(runner.step_counter) == state0["step"] + steps
        got = dict(zip(runner.names, metrics.numpy().T))
        np.testing.assert_array_equal(
            got.pop("cam_idx"), tds.data["cam_idx"].numpy()[perm[:steps]])
        jstate, jm = want[steps]
        assert set(got) == set(jm)
        for k, v in jm.items():
            if k in ("tile_overflow", "bbox_truncated", "tile_max_count",
                     "nonfinite_grads"):
                np.testing.assert_array_equal(got[k][:1], v[:1], err_msg=k)
                np.testing.assert_allclose(got[k], v, rtol=0.05, atol=2,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(got[k][:1], v[:1], rtol=1e-5,
                                           err_msg=k)
                np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
        for g in GROUPS:
            assert int(new.opt_state[g]["count"]) == steps
        if steps == 1:
            for g in GROUPS:
                mu, jmu = new.opt_state[g]["mu"].numpy(), \
                    jstate["opt_state"][g]["mu"]
                scale = max(float(np.abs(jmu).max()), 1e-12)
                err = float(np.abs(mu - jmu).max()) / scale
                assert err < 1e-4, (g, err)
            np.testing.assert_array_equal(new.stats.vis_count.numpy(),
                                          jstate["stats"]["vis_count"])


def test_eager_runner_bit_equal_to_per_step_loop(trainers):
    """On the CPU a chunk of the runner and the per-step loop (the step
    called once per camera of the same perm, on the same frames and random
    backgrounds) leave every state tensor bit-equal, and the same
    metrics."""
    t, _ = trainers
    n, d = 5, 1
    cfg = dataclasses.replace(t.cfg, background_color="random",
                              use_scale_regularization=True)
    ds = t._device_dataset(d)
    perm = t._next_perm(n)
    runner = scan_runner.make_scan_steps(cfg, t.optims, ds, n, device="cpu")
    step = runner.step
    start = 8      # steps 9 and 10: the scale regularizer on one of them
    s0 = dataclasses.replace(t.state, step=start)
    a = copy_state(s0, "cpu")
    bgs = torch.stack([background_color(cfg, "cpu", True,
                                        t._generator(start + i, 0))
                       for i in range(n)])
    a, metrics = runner(a, perm, bgs)
    b = copy_state(s0, "cpu")
    rows = []
    for i, p in enumerate(perm):
        batch = {"c2w": ds.data["c2w"][p], "K": ds.data["K"][p],
                 "cam_idx": int(ds.data["cam_idx"][p]),
                 "rgb": ds.data["rgb_u8"][p].numpy().astype(np.float32)
                 / 255.0, "depth": ds.data["depth"][p]}
        b, m = step(b, batch, t._generator(start + i, 0))
        rows.append([float(m[k]) for k in runner.names if k != "cam_idx"])
    assert a.step == b.step == start + n
    ta, tb = scan_runner.state_tensors(a), scan_runner.state_tensors(b)
    assert len(ta) == len(tb) == 7 + 6 * 3 + 1 + 3 + 3
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    np.testing.assert_array_equal(metrics[:, :-1].numpy(),
                                  np.asarray(rows, np.float32))
    assert float(metrics[:, runner.names.index("loss")].max()) > 0


def test_runner_holds_the_ssim_bands_it_reads(trainers, monkeypatch):
    """Every SSIM band matrix a chunk reads stays alive after SSIM's cache
    drops it: the runner's step holds them (a CUDA graph of the step keeps
    none of its inputs alive, so the cache alone would let a live graph
    read freed memory)."""
    import gc
    import weakref

    from qed_splatter_tpu_torch.ops import ssim as ssim_mod

    real, made = ssim_mod._band_matrix, []

    def recording(*args):
        band = real(*args)
        made.append(weakref.ref(band))
        return band

    monkeypatch.setattr(ssim_mod, "_band_matrix", recording)
    real.cache_clear()
    t, _ = trainers
    ds = t._device_dataset(1)
    runner = scan_runner.make_scan_steps(t.cfg, t.optims, ds, 2,
                                         device="cpu")
    runner(copy_state(t.state, "cpu"), t._next_perm(2))
    real.cache_clear()
    gc.collect()
    assert made and all(ref() is not None for ref in made)
