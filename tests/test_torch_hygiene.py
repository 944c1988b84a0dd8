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


def test_port_has_its_kernel_sources():
    srcs = sorted(p.name for p in (ROOT / "qed_splatter_tpu_torch" / "csrc")
                  .glob("*.cu"))
    assert srcs == ["composite.cu", "slab_gather.cu"]


def test_entry_points_raise_without_cuda(monkeypatch):
    from qed_splatter_tpu_torch.configs import ModelConfig
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
