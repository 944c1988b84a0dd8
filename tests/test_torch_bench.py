"""The port's bench (``qed_splatter_tpu_torch.bench``), its device lock
(``utils/chiplock.py``) and the trainer's ``profile_dir``, on the CPU at a
small size. The times a CPU run gives are not the card's: these tests hold
the bench's scene, its keys and its control flow, not its numbers."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qed_splatter_tpu_torch import bench
from qed_splatter_tpu_torch.utils import chiplock

ROOT = Path(__file__).resolve().parents[1]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {"rasterized_mpix_per_s", "device", "loss_finite",
              "dense_288k_alive_k1024_iters_per_s",
              "mixed_precision_iters_per_s"}


@pytest.mark.parametrize("mixed", [False, True])
def test_measure_two_steps_on_the_cpu(mixed):
    iters, finite = bench.measure(64, 48, 512, 300, 64, mixed, n_timed=1,
                                  device="cpu")
    assert iters > 0 and finite


def test_bench_scene_is_bench_py_scene(monkeypatch):
    """The port's scene is ``bench.py``'s: the same numpy draws in the same
    order give the same points and colours."""
    import bench as jbench
    from qed_splatter_tpu.models import gaussians as jg
    from qed_splatter_tpu_torch.models import gaussians as tg

    seen = {}

    def keep(name, real):
        def init(pts, rgb, *a, **kw):
            seen[name] = (np.array(pts), np.array(rgb))
            raise StopIteration
        return init

    monkeypatch.setattr(jg, "init_from_points", keep("jax", None))
    monkeypatch.setattr(tg, "init_from_points", keep("torch", None))
    for fn in (jbench.measure, bench.measure):
        with pytest.raises(StopIteration):
            kw = {} if fn is jbench.measure else {"device": "cpu"}
            fn(64, 48, 512, 300, 64, False, n_timed=1, **kw)
    for a, b in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(a, b)


def test_bench_line_has_bench_py_keys():
    line = bench.run("cpu", width=64, height=48, n_timed=1, dense_n_timed=1,
                     points=((512, 300, 64), (1024, 800, 128)))
    assert set(line) == BENCH_KEYS and set(line["extra"]) == EXTRA_KEYS
    assert line["metric"] == "train_iters_per_s_1296x840_80k_gaussians"
    assert line["unit"] == "iters/s" and line["extra"]["loss_finite"]
    assert line["vs_baseline"] == round(line["value"] / 30.0, 3)
    assert line["extra"]["device"] == "cpu"
    json.dumps(line)


@pytest.fixture
def lock_file(tmp_path, monkeypatch):
    path = tmp_path / "gpu.lock"
    monkeypatch.setenv("QED_CHIP_LOCK", str(path))
    chiplock.release_chip_lock()
    yield path
    chiplock.release_chip_lock()


def _hold(path):
    """Another holder of the lock (a second open file: flock conflicts
    between open files, even of one process)."""
    import fcntl

    fh = open(path, "a+")
    fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
    fh.write("pid 1 (another client)\n")
    fh.flush()
    return fh


def test_lock_second_holder_raises(lock_file):
    other = _hold(lock_file)
    try:
        with pytest.raises(chiplock.ChipBusy, match="another client"):
            chiplock.acquire_chip_lock("test", device="cuda")
        assert chiplock.acquire_chip_lock("test", required=False,
                                          device="cuda") is False
        # a CPU run never locks
        assert chiplock.acquire_chip_lock("test", device="cpu")
        assert chiplock._LOCK is None
    finally:
        other.close()
    assert chiplock.acquire_chip_lock("test", device="cuda:0")
    assert chiplock.acquire_chip_lock("again", device="cuda")   # reentrant
    assert f"pid {__import__('os').getpid()} (test)" in lock_file.read_text()


def test_lock_refuses_a_second_process(lock_file):
    assert chiplock.acquire_chip_lock("first", device="cuda")
    code = ("import sys; from qed_splatter_tpu_torch.utils import chiplock\n"
            "try:\n    chiplock.acquire_chip_lock('second', device='cuda')\n"
            "except chiplock.ChipBusy as e:\n    print(e); sys.exit(3)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3 and "(first)" in res.stdout


def test_cli_train_takes_the_lock_on_cuda(lock_file, tmp_path):
    from qed_splatter_tpu_torch import cli
    from qed_splatter_tpu_torch.testing import write_synthetic_dataset

    write_synthetic_dataset(tmp_path / "d", num_frames=2, width=32,
                            height=24)
    other = _hold(lock_file)
    try:
        with pytest.raises(chiplock.ChipBusy):
            cli.main(["train", "--data", str(tmp_path / "d"), "--device",
                      "cuda"])
        # on the CPU no lock is taken: the trainer runs beside the holder
        assert cli.main(["train", "--data", str(tmp_path / "d"), "--device",
                         "cpu", "--max-num-iterations", "2",
                         "--output-dir", str(tmp_path / "out"),
                         "--steps-per-dispatch", "1",
                         "--model.num-downscales", "0",
                         "--model.num-random", "500"]) == 0
    finally:
        other.close()


def test_bench_main_takes_the_lock(lock_file, monkeypatch):
    other = _hold(lock_file)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run", lambda *a, **kw: pytest.fail(
        "the bench ran without the lock"))
    try:
        with pytest.raises(chiplock.ChipBusy):
            bench.main(["--device", "cuda"])
    finally:
        other.close()


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir`` traces steps start + 10 to start + 14 of a trainer run
    into a Chrome trace and a ``key_averages`` table."""
    from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
        TrainerConfig
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.testing import write_synthetic_dataset

    write_synthetic_dataset(tmp_path / "d", num_frames=3, width=32,
                            height=24)
    prof = tmp_path / "prof"
    cfg = TrainerConfig(data=DataConfig(data=str(tmp_path / "d")),
                        output_dir=str(tmp_path / "out"),
                        max_num_iterations=16, steps_per_dispatch=1,
                        steps_per_eval_image=0, steps_per_eval_all_images=0,
                        steps_per_save=0, profile_dir=str(prof),
                        model=ModelConfig(max_per_tile=32, num_downscales=0,
                                          num_random=500))
    Trainer(cfg, device="cpu").train(finalize=False)
    trace = prof / "trace_steps_10-14.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # on the CPU the compositor's autograd node (on the card its kernels)
    assert any("composite" in n.lower() for n in names), sorted(names)[:20]
    table = (prof / "key_averages_steps_10-14.txt").read_text()
    assert "Self CPU" in table


def test_bench_and_tools_raise_without_cuda(monkeypatch):
    """The bench and the tools run on the card unless told otherwise; they
    never drift to the CPU."""
    from qed_splatter_tpu_torch.tools import bench_gather, bench_gather3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.measure(64, 48, 512, 300, 64, False, n_timed=1)
    for tool in (bench, bench_gather, bench_gather3):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main([])
