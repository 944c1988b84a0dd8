"""The port's ``testing.py`` against the JAX package's on the CPU: the
random scene and the simple camera exactly, the forest writer (BASELINE
config #4) file for file with its multi-view consistency, and the gaussian
teacher's dataset rendered by the port within one level and float32
rounding of the depth."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import qed_splatter_tpu.models.gaussians as jgaussians
from qed_splatter_tpu import testing as jtesting
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.data.png import read_png
from qed_splatter_tpu_torch.ops.knn import mean_knn_distance


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread (no oversubscription beside
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_scene_and_camera_equal_jax(seed):
    got = ttesting.random_scene(n=64, seed=seed, spread=1.5,
                                scale_range=(0.01, 0.2))
    want = jtesting.random_scene(n=64, seed=seed, spread=1.5,
                                 scale_range=(0.01, 0.2))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(ttesting.simple_camera(96, 40, 50.0),
                    jtesting.simple_camera(96, 40, 50.0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def forests(tmp_path_factory):
    root = tmp_path_factory.mktemp("forest")
    kw = dict(num_frames=6, width=128, height=72, seed=2, eval_every=3)
    jtesting.write_forest_dataset(root / "jax", **kw)
    ttesting.write_forest_dataset(root / "port", workers=2, **kw)
    return root / "jax", root / "port"


def test_forest_files_equal_jax(forests):
    """transforms.json equal, depth .npy byte-equal, images equal decoded
    (the PNG bytes differ: another encoder)."""
    jroot, troot = forests
    assert json.loads((troot / "transforms.json").read_text()) == \
        json.loads((jroot / "transforms.json").read_text())
    for i in range(6):
        name = f"frame_{i:04d}"
        assert (troot / "depth" / f"{name}.npy").read_bytes() == \
            (jroot / "depth" / f"{name}.npy").read_bytes()
        np.testing.assert_array_equal(
            read_png(troot / "images" / f"{name}.png"),
            np.asarray(Image.open(jroot / "images" / f"{name}.png")))


def test_forest_consistency_and_unscaled_frame(forests):
    """``tests/test_data_layer.py``'s forest check on the port's files:
    depth multi-view consistent in the unscaled odometry frame, sky at
    depth 0, metres-scale outdoor distances off the origin."""
    _, root = forests
    meta = json.loads((root / "transforms.json").read_text())
    assert len(meta["val_filenames"]) == 2
    d1 = np.load(root / "depth" / "frame_0001.npy") / 1000.0
    d2 = np.load(root / "depth" / "frame_0002.npy") / 1000.0
    c1 = np.asarray(meta["frames"][1]["transform_matrix"])
    c2 = np.asarray(meta["frames"][2]["transform_matrix"])
    assert np.linalg.norm(c1[:3, 3]) > 5.0
    f, cx, cy = meta["fl_x"], meta["cx"], meta["cy"]
    H, W = d1.shape
    assert (d1 == 0).any()
    assert (d1[d1 > 0] > 1.0).all()
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs = np.stack([(u - cx) / f, -(v - cy) / f, -np.ones_like(u)],
                    -1).reshape(-1, 3)
    hit = d1.reshape(-1) > 0
    pts = c1[:3, 3] + d1.reshape(-1, 1) * (dirs @ c1[:3, :3].T)
    pc = (pts[hit] - c2[:3, 3]) @ c2[:3, :3]
    z = -pc[:, 2]
    uu = f * (pc[:, 0] / z) + cx
    vv = f * (-pc[:, 1] / z) + cy
    ok = (z > 0.05) & (z < 12.0) & (uu >= 0) & (uu < W - 1) \
        & (vv >= 0) & (vv < H - 1)
    assert ok.sum() > 500
    u0 = np.floor(uu[ok]).astype(int)
    v0 = np.floor(vv[ok]).astype(int)
    diffs = np.stack([np.abs(d2[v0 + dv, u0 + du] - z[ok])
                      for dv in (0, 1) for du in (0, 1)])
    samp_any = np.stack([d2[v0 + dv, u0 + du]
                         for dv in (0, 1) for du in (0, 1)]).max(0)
    visible = samp_any > 0
    assert (diffs.min(0)[visible] < 0.1 * z[ok][visible]).mean() > 0.5


def test_gaussian_dataset_matches_jax(tmp_path, monkeypatch):
    """The teacher's frames rendered by the port: images within 1 level,
    the valid-depth masks equal and depth within 0.01 mm (float32 rounding
    at ~2.5 m in mm), transforms.json equal.

    The JAX teacher's scales come from its 3-NN mean, which excludes self
    by ``d2 <= 1e-12`` and so keeps a point's own near-zero distance (a
    known fault of ``qed_splatter_tpu/ops/knn.py``, ROADMAP.md queue 3);
    the port excludes by index. For the same teacher the JAX side is given
    the port's distance here."""
    monkeypatch.setattr(
        jgaussians, "mean_knn_distance",
        lambda p, k=3: jnp.asarray(mean_knn_distance(
            torch.as_tensor(np.array(p)), k=k).numpy()))
    kw = dict(num_frames=3, width=64, height=48, num_teacher=600, seed=1,
              eval_every=2)
    jtesting.write_gaussian_dataset(tmp_path / "jax", **kw)
    ttesting.write_gaussian_dataset(tmp_path / "port", device="cpu", **kw)
    assert json.loads((tmp_path / "port" / "transforms.json").read_text()) \
        == json.loads((tmp_path / "jax" / "transforms.json").read_text())
    for i in range(3):
        name = f"frame_{i:04d}"
        a = read_png(tmp_path / "port" / "images" / f"{name}.png")
        b = np.asarray(Image.open(tmp_path / "jax" / "images" / f"{name}.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        da = np.load(tmp_path / "port" / "depth" / f"{name}.npy")
        db = np.load(tmp_path / "jax" / "depth" / f"{name}.npy")
        np.testing.assert_array_equal(da > 0, db > 0)
        assert (db > 0).mean() > 0.2
        np.testing.assert_allclose(da, db, rtol=0, atol=0.01)
