"""The trainer's mesh path on the CPU: ``cli train --num-model-shards 2``
(two gloo ranks the command starts) against the single-device per-step
trainer through two refines and a capacity growth, ``num_data_shards=2``
against JAX's trainer at a 2x1 mesh through a refine, the ranks' adaptive
K across an eval, checkpoints that cross meshes both ways, the launcher's
one lock, and a capacity the model axis does not divide."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from qed_splatter_tpu.configs import DataConfig as JData
from qed_splatter_tpu.configs import ModelConfig as JModel
from qed_splatter_tpu.configs import TrainerConfig as JTrainerConfig
from qed_splatter_tpu.engine.trainer import Trainer as JTrainer
from qed_splatter_tpu_torch import cli
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine.train_step import from_jax_train_state
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.parallel import launch
from qed_splatter_tpu_torch.utils import chiplock
from test_torch_parallel import _state_np

STEPS = 32      # refines at 20 and 30; the capacity grows at 30
MODEL = dict(camera_opt_mode="off", max_per_tile=64, num_downscales=2,
             resolution_schedule=10, warmup_length=10, refine_every=10,
             init_capacity_headroom=1.2, sh_degree=1)
FLAGS = ["--device", "cpu", "--steps-per-dispatch", "1", "--log-every",
         "1", "--steps-per-save", "10", "--steps-per-eval-image", "0",
         "--steps-per-eval-all-images", "0",
         *[f"--model.{k.replace('_', '-')}={v}" for k, v in MODEL.items()]]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    ttesting.write_synthetic_dataset(root, num_frames=5, width=64,
                                     height=48, with_ply=True)
    return root


def _rows(run_dir, split):
    return [r for r in map(json.loads, open(run_dir / "metrics.jsonl"))
            if r["split"] == split]


def _config(dataset, out, **kw):
    return TrainerConfig(output_dir=str(out),
                         data=DataConfig(data=str(dataset)),
                         model=ModelConfig(**MODEL), max_num_iterations=STEPS,
                         steps_per_dispatch=1, log_every=1, steps_per_save=10,
                         steps_per_eval_image=0, steps_per_eval_all_images=0,
                         **kw)


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """(single-device run dir, M=2 run dir, lock calls of the launch)."""
    out = tmp_path_factory.mktemp("runs")
    single = Trainer(_config(dataset, out / "single"), device="cpu")
    single.train()
    calls = []
    # cmd_train imports it from the module when it runs
    orig = chiplock.acquire_chip_lock

    def counting(purpose, *a, **k):
        calls.append(purpose)
        return orig(purpose, *a, **k)

    chiplock.acquire_chip_lock = counting
    try:
        rc = cli.main(["train", "--data", str(dataset), "--output-dir",
                       str(out / "m2"), "--max-num-iterations", str(STEPS),
                       "--num-model-shards", "2", *FLAGS])
    finally:
        chiplock.acquire_chip_lock = orig
    assert rc == 0
    return single.run_dir, out / "m2" / "qed-splatter", calls


def test_model_sharded_matches_single_through_refine(runs):
    """Every step's loss within 1e-4 relative of the single-device
    per-step trainer's (the same cameras, backgrounds and state), the
    refines at steps 20 and 30 keep the same gaussians, the capacity grows
    at 30 on both (the gathered state grows, then is sharded again), and
    the final states agree."""
    single, sharded, _ = runs
    a, b = _rows(single, "train"), _rows(sharded, "train")
    assert [r["step"] for r in a] == [r["step"] for r in b] == list(
        range(1, STEPS + 1))
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(rb["loss"], ra["loss"], rtol=1e-4,
                                   err_msg=f"step {ra['step']}")
        assert rb["gaussian_count"] == ra["gaussian_count"]
    assert "bbox_truncated" not in b[0]      # the JAX sharded step's keys
    ra, rb = _rows(single, "refine"), _rows(sharded, "refine")
    assert [r["step"] for r in ra] == [r["step"] for r in rb] == [20, 30]
    for x, y in zip(ra, rb):
        for k in ("n_alive", "n_culled", "n_split", "n_dup"):
            assert x[k] == y[k], k
    assert ra[0]["n_split"] > 0
    ga, gb = _rows(single, "grow"), _rows(sharded, "grow")
    assert [(r["step"], r["capacity_after"]) for r in ga] == [
        (r["step"], r["capacity_after"]) for r in gb] == [(30, 1024)]
    sa = ckpt.load_state(single / "ckpts", "cpu")
    sb = ckpt.load_state(sharded / "ckpts", "cpu")
    assert sa.step == sb.step == STEPS
    assert torch.equal(sa.params.alive, sb.params.alive)
    np.testing.assert_allclose(sb.params.means, sa.params.means, atol=1e-5)


def test_launcher_takes_the_lock_once(runs):
    """``cli train`` with two ranks asks for the device lock once, in the
    launching process (a rank's own would find the launcher's flock)."""
    assert runs[2] == ["qed train"]


def test_view_parallel_matches_jax_through_refine(dataset, tmp_path):
    """``num_data_shards=2`` (two cameras a step, two gloo ranks) against
    JAX's trainer at a 2x1 mesh of the virtual CPU devices, both from
    JAX's initial state (its scales made anisotropic), with camera opt
    on and JAX's split offsets: every step's loss within 1e-4 through the
    refine at step 20 (the statistics of two cameras a step) and two steps
    after it, the refine's counts equal, the final alive set equal and the
    means within 1e-5. The capacity has room for the refine: JAX's mesh
    path fails at a growth (ROADMAP, "Found in the reference")."""
    model = {**MODEL, "num_downscales": 0, "init_capacity_headroom": 4.0,
             "camera_opt_mode": "SO3xR3", "background_color": "black"}
    kw = dict(max_num_iterations=22, steps_per_dispatch=1, log_every=1,
              steps_per_save=0, steps_per_eval_image=0,
              steps_per_eval_all_images=0, num_data_shards=2)
    j = JTrainer(JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                data=JData(data=str(dataset)),
                                model=JModel(**model), **kw))
    # anisotropic scales: with the seed points' isotropic ones the quats'
    # gradient is rounding noise, Adam turns it into lr-sized steps, and
    # the split children's offsets R(q) (s * eps) part by them
    p = j.state.params
    j.state = j.state.replace(params=p.replace(scales=jax.numpy.asarray(
        np.asarray(p.scales) + np.random.default_rng(1).normal(
            0, 0.4, p.scales.shape).astype(np.float32))))
    start = ckpt.save_checkpoint(tmp_path / "start", from_jax_train_state(
        _state_np(j.state), device="cpu"), 0).parent
    eps, refine_jit = {}, j._refine_jit

    def capture(params, opt_state, stats, step, key, cfg, **rest):
        eps[int(step)] = np.asarray(jax.random.normal(
            key, (min(65_536, params.capacity), 3)))
        return refine_jit(params, opt_state, stats, step, key, cfg, **rest)

    j._refine_jit = capture
    j.train()
    cfg = TrainerConfig(output_dir=str(tmp_path / "port"),
                        data=DataConfig(data=str(dataset)),
                        model=ModelConfig(**model), load_dir=str(start),
                        **kw)
    out = tmp_path / "rank0.pt"
    launch.spawn(launch.run_rank, 2, (
        ranks.one_thread, 2, launch.free_port(),
        (ranks.train, cfg, str(out), eps)), timeout=240.0)
    a = _rows(tmp_path / "jax" / "qed-splatter", "train")
    b = _rows(tmp_path / "port" / "qed-splatter", "train")
    assert [r["step"] for r in a] == [r["step"] for r in b] == list(
        range(1, 23))
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(rb["loss"], ra["loss"], rtol=1e-4,
                                   err_msg=f"step {ra['step']}")
    ra = _rows(tmp_path / "jax" / "qed-splatter", "refine")
    rb = _rows(tmp_path / "port" / "qed-splatter", "refine")
    assert [r["step"] for r in ra] == [r["step"] for r in rb] == [20]
    for k in ("n_alive", "n_culled", "n_split", "n_dup", "n_dropped"):
        assert ra[0][k] == rb[0][k], k
    assert ra[0]["n_split"] > 0
    got = torch.load(out, weights_only=False)
    assert got["mesh"] == (2, 1, "gloo")
    np.testing.assert_array_equal(got["alive"],
                                  np.asarray(j.state.params.alive))
    np.testing.assert_allclose(got["means"],
                               np.asarray(j.state.params.means), atol=1e-5)


def test_eval_keeps_the_ranks_k_tables_one(dataset, tmp_path):
    """An eval renders on rank 0 alone, and it seeds the K of the bucket
    it renders. Here eval_all at step 4 seeds the full-resolution bucket
    from the 1/4 bucket's K of then; K grows at 1/4 after it, and training
    reaches full resolution at step 21. Every rank holds the single-device
    run's K table before and after every step, and the 1x2 run's losses
    stay within 1e-4 of the single run's."""
    cfg = dataclasses.replace(
        _config(dataset, tmp_path / "single"), max_num_iterations=24,
        steps_per_save=0, steps_per_eval_all_images=4,
        model=ModelConfig(**{**MODEL, "max_per_tile": 8}))
    ranks.train(cfg, str(tmp_path / "single.pt"))
    mesh_cfg = dataclasses.replace(cfg, output_dir=str(tmp_path / "m2"),
                                   num_model_shards=2)
    launch.spawn(launch.run_rank, 2, (
        ranks.one_thread, 2, launch.free_port(),
        (ranks.train, mesh_cfg, str(tmp_path / "m2.pt"))), timeout=240.0)
    (want,) = torch.load(tmp_path / "single.pt", weights_only=False)[
        "k_tables"]
    got = torch.load(tmp_path / "m2.pt", weights_only=False)["k_tables"]
    # the case this holds: the full-resolution bucket seeded by the eval
    # under the K the 1/4 bucket grew to
    at_21 = next(before for step, before, _ in want if step == 21)
    assert at_21[1] < at_21[4], want
    for rank, tables in enumerate(got):
        assert tables == want, f"rank {rank}"
    a = _rows(tmp_path / "single" / "qed-splatter", "train")
    b = _rows(tmp_path / "m2" / "qed-splatter", "train")
    assert [r["step"] for r in a] == [r["step"] for r in b] == list(
        range(1, 25))
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(rb["loss"], ra["loss"], rtol=1e-4,
                                   err_msg=f"step {ra['step']}")
    assert len(_rows(tmp_path / "m2" / "qed-splatter", "eval_all")) == 6


@pytest.mark.parametrize("m_from,m_to", [(2, 1), (1, 2)])
def test_checkpoint_crosses_meshes(dataset, runs, tmp_path, m_from, m_to):
    """A checkpoint written by one mesh loads whole in the other: resumed
    with no steps left, the run's own checkpoint at that step equals the
    one it loaded, tensor for tensor."""
    single, sharded, _ = runs
    src = (sharded if m_from == 2 else single) / "ckpts"
    cfg = _config(dataset, tmp_path, load_dir=str(src),
                  num_model_shards=m_to)
    out = tmp_path / "final.pt"
    if m_to == 1:
        ranks.train(cfg, str(out))
    else:
        launch.spawn(launch.run_rank, 2, (
            ranks.one_thread, 2, launch.free_port(),
            (ranks.train, cfg, str(out))), timeout=240.0)
    got = torch.load(out, weights_only=False)
    assert got["local_capacity"] * m_to == ckpt.load_state(
        src, "cpu").params.capacity
    want = ckpt.state_to_dict(ckpt.load_state(src, "cpu"))
    back = ckpt.state_to_dict(ckpt.load_state(
        tmp_path / "qed-splatter" / "ckpts", "cpu"))
    assert back["step"] == want["step"] == STEPS

    def walk(x, y, at):
        if isinstance(x, dict):
            assert set(x) == set(y), at
            for k in x:
                walk(x[k], y[k], f"{at}.{k}")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), at
        else:
            assert x == y, at

    walk(back, want, "state")


def test_capacity_not_divisible_raises(dataset, tmp_path):
    """Three model shards of a capacity of 512 rows: every rank raises,
    naming both numbers, and the launch fails with that traceback."""
    with pytest.raises(Exception, match="capacity 512 is not divisible by "
                                        "num_model_shards 3"):
        cli.main(["train", "--data", str(dataset), "--output-dir",
                  str(tmp_path), "--max-num-iterations", "2",
                  "--num-model-shards", "3", *FLAGS])
