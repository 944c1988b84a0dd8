"""The port's trainer, checkpoints, metrics and CLI against the JAX package
on the CPU: the trainer's decisions (resolution schedule, adaptive K and
pair budget, eval K) on the same inputs, the step cache keyed on the pair
budget, checkpoints that keep ``tpg_by_d`` through ``finalize``, the PLY
export byte for byte, rollback, the growth canary, a whole training drive,
and the refusal of what the port does not have."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu import metrics as jmetrics
from qed_splatter_tpu import testing as jtesting
from qed_splatter_tpu.configs import DataConfig as JData
from qed_splatter_tpu.configs import ModelConfig as JModel
from qed_splatter_tpu.configs import TrainerConfig as JTrainerConfig
from qed_splatter_tpu.engine import checkpoint as jckpt
from qed_splatter_tpu.engine.trainer import Trainer as JTrainer
from qed_splatter_tpu.models.gaussians import init_random as jinit_random
from qed_splatter_tpu_torch import metrics
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.cli import build_trainer_config, main
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine import trainer as trainer_mod
from qed_splatter_tpu_torch.engine.trainer import Trainer, TrainingDiverged
from qed_splatter_tpu_torch.engine.writer import MetricsWriter
from qed_splatter_tpu_torch.models.gaussians import FIELDS, from_jax_arrays


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    jtesting.write_synthetic_dataset(root, num_frames=5, width=64,
                                     height=48, with_ply=True)
    return root


MODEL_KW = dict(camera_opt_mode="off", max_per_tile=64, num_downscales=2,
                resolution_schedule=20, warmup_length=10, refine_every=10,
                init_capacity_headroom=1.2, sh_degree=1)


def _config(dataset, tmp_path, **kw):
    model = ModelConfig(**{**MODEL_KW, **kw.pop("model_kw", {})})
    base = dict(max_num_iterations=40, steps_per_eval_image=0,
                steps_per_eval_all_images=0, steps_per_save=10, log_every=10,
                steps_per_dispatch=1)
    return TrainerConfig(output_dir=str(tmp_path),
                         data=DataConfig(data=str(dataset)), model=model,
                         **{**base, **kw})


@pytest.fixture
def trainers(dataset, tmp_path):
    jcfg = JTrainerConfig(
        steps_per_dispatch=1, output_dir=str(tmp_path / "j"),
        data=JData(data=str(dataset)), model=JModel(**MODEL_KW))
    return (Trainer(_config(dataset, tmp_path / "t"), device="cpu"),
            JTrainer(jcfg))


def test_decisions_match_jax(trainers):
    """The resolution schedule, per-bucket K (seeding, growth, shrink,
    eval K) and pair budget, driven by one sequence of inputs."""
    t, j = trainers
    assert [t._downscale_factor(s) for s in range(0, 100, 5)] == [
        j._downscale_factor(s) for s in range(0, 100, 5)]
    rng = np.random.default_rng(0)
    for i in range(60):
        d = int(rng.choice([4, 2, 1]))
        w, h = 64 // d, 48 // d
        k = t._k_for(d)
        assert k == j._k_for(d)
        tiles = (-(-w // 16)) * (-(-h // 16))
        overflow = float(rng.choice([0.0, 0.05, 0.2]) * tiles * k)
        max_count = float(rng.choice([1.0, k / 4, k * 2]))
        bbox = float(rng.choice([0.0, 0.1, 10.0]))
        for tr in (t, j):
            tr._maybe_adapt_k(overflow, max_count, w, h, d)
            tr._maybe_adapt_tpg(bbox, d)
        assert t._k_by_d == j._k_by_d, i
        assert t._tpg_for(d) == j._tpg_for(d), i
        assert t._tpg_by_d == j._tpg_by_d, i
        assert t._k_eval(d) == j._k_eval(d), i
    assert max(t._k_by_d.values()) > 64 and max(t._tpg_by_d.values()) > 8
    for tr in (t, j):
        tr._maybe_adapt_k(None, None, 64, 48, 1)
        tr._maybe_adapt_tpg(None, 1)
    assert t._k_by_d == j._k_by_d and t._tpg_by_d == j._tpg_by_d


def test_step_cache_keys_on_the_pair_budget(trainers):
    """A pair-budget escalation reaches the step: the port's cache keys on
    it (the JAX package's does not, and keeps the stale step)."""
    t, j = trainers
    t._sync_bucket_cfg(1)
    before = t._get_step_fn(64, 48, True, False, 512)
    assert before.cfg.small_tiles_per_gaussian == 8
    t._maybe_adapt_tpg(1e9, 1)
    t._sync_bucket_cfg(1)
    after = t._get_step_fn(64, 48, True, False, 512)
    assert after is not before
    assert after.cfg.small_tiles_per_gaussian == t._tpg_by_d[1] == 16
    j_before = j._get_step_fn(64, 48, True, False, 512)
    j.cfg = dataclasses.replace(j.cfg, small_tiles_per_gaussian=16)
    assert j._get_step_fn(64, 48, True, False, 512) is j_before


def test_checkpoint_roundtrip_keeps_tpg_through_finalize(dataset, tmp_path):
    cfg = _config(dataset, tmp_path, max_num_iterations=12,
                  steps_per_eval_image=6, steps_per_eval_batch=6,
                  model_kw=dict(num_downscales=0, adaptive_max_per_tile=False,
                                adaptive_pair_budget=False))
    t = Trainer(cfg, device="cpu")
    t._tpg_by_d[1] = 32
    t._k_by_d[1] = 128
    t.train()
    root = t.run_dir / "ckpts"
    meta = ckpt.checkpoint_meta(root)
    assert meta["step"] == 12 and meta["tpg_by_d"] == {"1": 32}
    assert meta["k_by_d"] == {"1": 128}
    assert meta["capacity"] == t.state.params.capacity
    assert ckpt.model_config_from_meta(meta) == t.cfg
    restored = ckpt.restore_checkpoint(ckpt.latest_checkpoint(root), "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(restored.params, f),
                           getattr(t.state.params, f))
    for g, s in t.state.opt_state.items():
        for k, v in s.items():
            assert torch.equal(restored.opt_state[g][k], v)
    assert torch.equal(restored.camera_opt, t.state.camera_opt)
    assert restored.step == 12
    # a checkpoint is a copy: training on does not change it
    t.train(max_steps=14, finalize=False)
    again = ckpt.restore_checkpoint(root / "step-000000012", "cpu")
    assert torch.equal(again.params.means, restored.params.means)
    resumed = Trainer(dataclasses.replace(cfg, load_dir=str(root)),
                      device="cpu")
    assert resumed.state.step == 12
    assert resumed._tpg_by_d == {1: 32} and resumed._k_by_d == {1: 128}
    assert (t.run_dir / "splat.ply").exists()
    rows = [json.loads(x) for x in open(t.run_dir / "metrics.jsonl")]
    evals = [r for r in rows if r["split"] == "eval"]
    losses = [r for r in rows if r["split"] == "eval_loss"]
    assert [r["step"] for r in evals] == [r["step"] for r in losses] == [6,
                                                                         12]
    assert all(np.isfinite(r["rgb_psnr"]) and np.isfinite(r["depth_abs_rel"])
               for r in evals)
    assert all(np.isfinite(r["main_loss"]) for r in losses)


def test_export_ply_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    p = jinit_random(num_points=100, capacity=256, sh_degree=2, seed=1)
    p = p.replace(features_rest=jnp.asarray(rng.normal(
        0, 1, p.features_rest.shape).astype(np.float32)),
        alive=jnp.asarray(rng.uniform(size=256) < 0.5))
    tp = from_jax_arrays({f: np.asarray(getattr(p, f)) for f in FIELDS},
                         device="cpu")
    t34 = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1))], 1)
    for meta in (None, {"dataparser_transform": t34.tolist(),
                        "dataparser_scale": 0.37}):
        n = ckpt.export_ply(tmp_path / "t.ply", tp, meta)
        jckpt.export_ply(tmp_path / "j.ply", p, meta)
        assert n == int(np.asarray(p.alive).sum())
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply"
                                                      ).read_bytes()


def _poison(trainer):
    trainer.state.params.means.fill_(float("nan"))


def test_rollback_after_nan(dataset, tmp_path):
    cfg = _config(dataset, tmp_path, on_divergence="rollback",
                  divergence_freeze_steps=20, steps_per_save=5, log_every=5,
                  model_kw=dict(num_downscales=0))
    t = Trainer(cfg, device="cpu")
    t.train(max_steps=10, finalize=False)
    assert t._good_ckpt == 10
    _poison(t)
    t.train(max_steps=20, finalize=False)
    assert t._rollbacks == 1 and t.state.step == 20
    assert t._densify_frozen_until == 30
    assert torch.isfinite(t.state.params.means).all()
    assert (t.run_dir / "postmortem").exists()
    # halt: the same poisoning raises
    t2 = Trainer(dataclasses.replace(cfg, on_divergence="halt",
                                     experiment_name="halt"), device="cpu")
    t2.train(max_steps=5, finalize=False)
    _poison(t2)
    with pytest.raises(TrainingDiverged):
        t2.train(max_steps=15, finalize=False)


@pytest.mark.parametrize("where", ["refine", "step"])
def test_growth_canary_reverts_on_oom(dataset, tmp_path, monkeypatch,
                                      where):
    """An out-of-memory error in the refine or the first step after a
    growth restores the pre-growth state, refuses that capacity and runs
    that cadence's refine again at the old capacity."""
    cfg = _config(dataset, tmp_path, log_every=1, model_kw=dict(
        num_downscales=0, warmup_length=2, refine_every=4))
    t = Trainer(cfg, device="cpu")
    t.train(max_steps=3, finalize=False)
    cap = t.state.params.capacity
    # force the trigger: every slot alive
    t.state.params.alive.fill_(True)
    failed = []
    if where == "refine":
        real = trainer_mod.refine

        def refine_oom(params, *a, **kw):
            if params.capacity > cap and not failed:
                failed.append(params.capacity)
                raise torch.cuda.OutOfMemoryError("injected")
            return real(params, *a, **kw)
        monkeypatch.setattr(trainer_mod, "refine", refine_oom)
    else:
        real_get = t._get_step_fn

        def get(*a, **kw):
            fn = real_get(*a, **kw)

            def run(state, batch, gen):
                if state.params.capacity > cap and not failed:
                    failed.append(state.params.capacity)
                    raise torch.cuda.OutOfMemoryError("injected")
                return fn(state, batch, gen)
            return run
        monkeypatch.setattr(t, "_get_step_fn", get)
    t.train(max_steps=4, finalize=False)      # the refine at 4 grows
    pre = None
    if where == "step":
        assert t.state.params.capacity == 2 * cap and t._canary is not None
        pre = t._canary[2]
        t.train(max_steps=5, finalize=False)
    assert failed == [2 * cap]
    assert t._grow_refused == {2 * cap} and t._canary is None
    assert t.state.params.capacity == cap
    # refine ran again, at the old capacity, on the pre-growth state: a
    # refine row at step 4 after the growth's (the first row is the refine
    # at the grown capacity, whose result the failed step threw away)
    rows = [json.loads(x) for x in open(t.run_dir / "metrics.jsonl")]
    splits = [(r["split"], r["step"]) for r in rows
              if r["split"] in ("grow", "refine")]
    assert splits == ([("grow", 4), ("refine", 4)] if where == "refine" else
                      [("grow", 4), ("refine", 4), ("refine", 4)])
    if where == "step":
        # the state from before that refine came back, was refined (its
        # stats reset) and stepped on
        assert t.state.step == 5 and pre.step == 4
        assert float(pre.stats.vis_count.max()) > 1.0
        assert float(t.state.stats.vis_count.max()) <= 1.0
    # the refused capacity is never tried again
    t.state.params.alive.fill_(True)
    t.train(max_steps=9, finalize=False)
    assert t.state.params.capacity == cap and len(failed) == 1


# ROADMAP items done since their options were refused here: 7 (the
# mixed_precision kernels) and 12 (profile_dir, with the port's bench)
PORTED_ITEMS = (7, 12)


@pytest.mark.parametrize("kw,item", [
    (dict(steps_per_dispatch=4), 1), (dict(supervise=True), 2),
    (dict(num_data_shards=2), 8), (dict(vis="viewer"), 10),
    (dict(mixed_precision=True), 7), (dict(vis="tensorboard"), 9),
    (dict(vis="wandb"), 9), (dict(vis="comet"), 9),
    (dict(profile_dir="trace"), 12),
    (dict(model_kw=dict(use_bilateral_grid=True)), 6)])
def test_trainer_refuses_unported(dataset, tmp_path, kw, item):
    if item in PORTED_ITEMS:
        # ported since: the option builds a trainer (its runs are held in
        # test_profile_dir_writes_a_trace and tests/test_torch_mixed_precision)
        t = Trainer(_config(dataset, tmp_path, **kw), device="cpu")
        assert t.config.mixed_precision == t.cfg.mixed_precision
        return
    name = kw.get("vis") or ""
    with pytest.raises(NotImplementedError,
                       match=f"{name}.*ROADMAP.md, 'Next, in order' item "
                             f"{item},"):
        Trainer(_config(dataset, tmp_path, **kw), device="cpu")


def test_writer_rows(tmp_path):
    w = MetricsWriter(tmp_path, console_every=0)
    w.write(5, {"loss": torch.tensor(0.5), "skip": "text"})
    w.close()
    row = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert row["step"] == 5 and row["loss"] == 0.5 and "skip" not in row


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(
        np.float32)
    dp = rng.uniform(0.5, 4, (40, 56, 1)).astype(np.float32)
    dg = dp * rng.uniform(0.8, 1.3, dp.shape).astype(np.float32)
    dg[:5] = 0.0
    dp[10, :4] = -1.0
    got = metrics.full_eval_metrics(torch.as_tensor(pred),
                                    torch.as_tensor(gt), torch.as_tensor(dp),
                                    torch.as_tensor(dg), gaussian_count=7,
                                    avg_min_scale=0.25)
    want = jmetrics.full_eval_metrics(jnp.asarray(pred), jnp.asarray(gt),
                                      jnp.asarray(dp), jnp.asarray(dg),
                                      gaussian_count=7, avg_min_scale=0.25)
    assert set(got) == set(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5,
                                       atol=1e-6, err_msg=k)
    u8 = (pred * 255).astype(np.uint8)
    np.testing.assert_allclose(float(metrics.psnr(torch.as_tensor(u8),
                                                   torch.as_tensor(gt))),
                               float(jmetrics.psnr(jnp.asarray(u8),
                                                   jnp.asarray(gt))),
                               rtol=1e-5)
    empty = metrics.depth_metrics(torch.zeros(4, 4), torch.zeros(4, 4))
    assert all(np.isnan(float(v)) for v in empty)
    scales = rng.normal(-3, 1, (30, 3)).astype(np.float32)
    alive = rng.uniform(size=30) < 0.6
    np.testing.assert_allclose(
        float(metrics.avg_min_scale(torch.as_tensor(scales),
                                    torch.as_tensor(alive))),
        float(jmetrics.avg_min_scale(jnp.asarray(scales),
                                     jnp.asarray(alive))), rtol=1e-6)


def test_cli_train_on_the_cpu(dataset, tmp_path):
    argv = ["--data", str(dataset), "--device", "cpu",
            "--output-dir", str(tmp_path), "--max-num-iterations", "3",
            "--steps-per-eval-image", "0", "--steps-per-eval-all-images",
            "0", "--model.camera-opt-mode", "off", "--model.max-per-tile",
            "64", "--no-model.adaptive-max-per-tile"]
    cfg, device = build_trainer_config(argv)
    assert device == "cpu" and cfg.max_num_iterations == 3
    assert cfg.model.camera_opt_mode == "off"
    assert cfg.model.adaptive_max_per_tile is False
    assert main(["train", *argv]) == 0
    assert (tmp_path / "qed-splatter" / "splat.ply").exists()
    assert ckpt.checkpoint_meta(tmp_path / "qed-splatter" / "ckpts")[
        "step"] == 3
    for cmd in ("eval", "export", "render", "view", "init-pc", "eval-pc",
                "train-multi"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            main([cmd])
    assert main(["nonsense"]) == 2


def test_trainer_drive_raises_psnr_and_adds_gaussians(tmp_path):
    """150 steps on the room dataset at 64x48 from its sparse points, half
    resolution first, with refine and capacity growth: eval PSNR rises and
    refine adds gaussians."""
    root = tmp_path / "room"
    ttesting.write_room_dataset(root, num_frames=10, width=64, height=48,
                                sparse_ply=600)
    model = ModelConfig(camera_opt_mode="off", max_per_tile=64,
                        num_downscales=1, resolution_schedule=50,
                        warmup_length=20, refine_every=10,
                        init_capacity_headroom=1.1, sh_degree=0,
                        max_capacity=2048, max_per_tile_limit=512)
    cfg = TrainerConfig(max_num_iterations=150, steps_per_eval_image=50,
                        steps_per_eval_all_images=0, steps_per_save=0,
                        log_every=10, output_dir=str(tmp_path / "out"),
                        data=DataConfig(data=str(root)), model=model, seed=0,
                        steps_per_dispatch=1)
    t = Trainer(cfg, device="cpu")
    first = t.eval_all(0)
    t.train()
    last = t.eval_all(150)
    rows = [json.loads(x) for x in open(t.run_dir / "metrics.jsonl")]
    added = sum(r["n_added"] for r in rows if r["split"] == "refine")
    grows = [r for r in rows if r["split"] == "grow"]
    assert added > 0 and grows
    assert last["gaussian_count"] > first["gaussian_count"]
    assert last["rgb_psnr"] > first["rgb_psnr"] + 2.0, (first, last)
    assert all(np.isfinite(r["loss"]) for r in rows if r["split"] == "train")
