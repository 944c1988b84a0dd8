"""Multi-scene training on the port (CPU), each case of
``tests/test_multi_scene.py``: round-robin scheduling with per-scene
artifacts and one hot path for same-shaped scenes, the ``train-multi``
command, scenes by process and unique scene names."""

import numpy as np
import pytest
import torch

from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.engine import scan_runner
from qed_splatter_tpu_torch.engine.multi_scene import MultiSceneTrainer


@pytest.fixture(scope="module")
def two_scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    for i, name in enumerate(["sceneA", "sceneB"]):
        ttesting.write_synthetic_dataset(root / name, num_frames=5, width=64,
                                         height=48, with_ply=True, seed=i)
    return root


def _cfg(tmp_path, **kw):
    return TrainerConfig(
        max_num_iterations=20, steps_per_eval_image=10,
        steps_per_eval_all_images=0, steps_per_save=10, log_every=10,
        output_dir=str(tmp_path), experiment_name="multi",
        data=DataConfig(data=""),
        # a fixed K: adaptive growth would split the scenes onto different
        # steps mid-test
        model=ModelConfig(camera_opt_mode="off", max_per_tile=64,
                          adaptive_max_per_tile=False, num_downscales=1,
                          resolution_schedule=20, warmup_length=10,
                          refine_every=10),
        **kw)


def test_multi_scene_round_robin(two_scenes, tmp_path, monkeypatch):
    calls = []
    orig = scan_runner.make_train_step

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(scan_runner, "make_train_step", counting)
    mst = MultiSceneTrainer(_cfg(tmp_path), [str(two_scenes / "sceneA"),
                                             str(two_scenes / "sceneB")],
                            device="cpu")
    turns = []
    for name, tr in mst.trainers.items():
        real = tr.train

        def train(max_steps=None, finalize=True, _name=name, _real=real):
            turns.append((_name, max_steps))
            return _real(max_steps=max_steps, finalize=finalize)
        tr.train = train
    states = mst.train()
    assert turns == [("sceneA", 10), ("sceneB", 10), ("sceneA", 20),
                     ("sceneB", 20)]
    assert set(states) == {"sceneA", "sceneB"}
    for name, state in states.items():
        assert state.step == 20
        run = tmp_path / "multi" / name
        assert (run / "ckpts" / "step-000000020").exists()
        assert (run / "splat.ply").exists()
        assert (run / "metrics.jsonl").exists()
        assert bool(torch.isfinite(state.params.means).all())
    # the scenes differ (other seeds, other reconstructions)
    a = states["sceneA"].params.means.numpy()
    b = states["sceneB"].params.means.numpy()
    assert a.shape == b.shape and not np.allclose(a, b)
    # each scene builds its step once for the bucket, not once per turn
    assert len(calls) == 2, f"expected 1 step build per scene, got {calls}"
    assert all(tr._use_scan() for tr in mst.trainers.values())


def test_multi_scene_cli(two_scenes, tmp_path):
    from qed_splatter_tpu_torch.cli import main

    rc = main([
        "train-multi", "--data", str(two_scenes / "sceneA"),
        "--data", str(two_scenes / "sceneB"), "--device", "cpu",
        "--output-dir", str(tmp_path), "--experiment-name", "multicli",
        "--max-num-iterations", "10", "--steps-per-eval-image", "0",
        "--steps-per-eval-all-images", "0", "--steps-per-save", "10",
        "--log-every", "10", "--model.camera-opt-mode", "off",
        "--model.max-per-tile", "64", "--model.warmup-length", "10",
        "--model.refine-every", "10",
    ])
    assert rc == 0
    for name in ("sceneA", "sceneB"):
        assert (tmp_path / "multicli" / name / "splat.ply").exists()


def test_multi_scene_process_sharding(two_scenes, tmp_path, monkeypatch):
    """Scene assignment is i::P by the torch.distributed rank."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    mst = MultiSceneTrainer(_cfg(tmp_path), [str(two_scenes / "sceneA"),
                                             str(two_scenes / "sceneB")],
                            device="cpu")
    assert list(mst.trainers) == ["sceneB"]


def test_multi_scene_rejects_duplicate_names(two_scenes, tmp_path):
    with pytest.raises(ValueError, match="unique"):
        MultiSceneTrainer(_cfg(tmp_path), [str(two_scenes / "sceneA"),
                                           str(two_scenes / "sceneA")],
                          device="cpu")
