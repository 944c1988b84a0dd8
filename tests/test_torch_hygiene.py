"""The PyTorch port stands alone: no module of ``qed_splatter_tpu_torch``
and not ``chip_smoke.py`` imports JAX or the JAX package, and entry points
refuse to drift to the CPU when CUDA is absent."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "qed_splatter_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "qed_splatter_tpu")
# not installed on the GPU machine: the port has its own PNG codec and
# checkpoint format
NOT_ON_THE_CARD = ("PIL", "cv2", "imageio", "orbax", "tensorboard")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_needs_no_imaging_or_checkpoint_library(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in NOT_ON_THE_CARD]
    assert not bad, f"{path.name} imports {bad}"


def test_hygiene_covers_the_trainer_path():
    names = {str(p.relative_to(ROOT / "qed_splatter_tpu_torch"))
             for p in PORT_FILES[:-1]}
    assert {"data/png.py", "data/ply.py", "data/transforms_json.py",
            "data/undistort.py", "data/dataset.py", "engine/densify.py",
            "engine/writer.py", "engine/checkpoint.py", "engine/trainer.py",
            "metrics.py", "cli.py", "testing.py"} <= names


def test_hygiene_covers_the_bench_path():
    names = {str(p.relative_to(ROOT / "qed_splatter_tpu_torch"))
             for p in PORT_FILES[:-1]}
    assert {"bench.py", "utils/chiplock.py", "utils/microbench.py",
            "tools/bench_gather.py", "tools/bench_gather3.py",
            "ops/copy_rows.py"} <= names


def test_port_has_its_kernel_sources():
    srcs = sorted(p.name for p in (ROOT / "qed_splatter_tpu_torch" / "csrc")
                  .glob("*.cu"))
    assert srcs == ["composite.cu", "composite_bwd.cu", "copy_rows.cu",
                    "slab_gather.cu"]


def test_entry_points_raise_without_cuda(monkeypatch):
    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import make_train_step
    from qed_splatter_tpu_torch.models import gaussians
    from qed_splatter_tpu_torch.models.splatfacto import render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).uniform(-1, 1, (32, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gaussians.init_from_points(pts, None)
    params = gaussians.init_from_points(pts, None, device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    K = np.array([[20, 0, 8], [0, 20, 8], [0, 0, 1]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(params, c2w, K, 16, 16, ModelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gaussians.from_jax_arrays(
            {f: getattr(params, f).numpy() for f in gaussians.FIELDS})
    optims = GroupOptimizers(default_optimizers())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(ModelConfig(), optims, 16, 16, has_depth=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gaussians.init_random(16, capacity=256)


def test_trainer_raises_without_cuda(monkeypatch, tmp_path):
    from qed_splatter_tpu_torch.configs import DataConfig, TrainerConfig
    from qed_splatter_tpu_torch.engine import checkpoint
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.testing import write_synthetic_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_synthetic_dataset(tmp_path / "d", num_frames=2, width=16,
                            height=16)
    cfg = TrainerConfig(data=DataConfig(data=str(tmp_path / "d")),
                        output_dir=str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.restore_checkpoint(tmp_path)
