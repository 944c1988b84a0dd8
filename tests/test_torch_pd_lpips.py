"""The port's point-cloud metrics and LPIPS against the JAX package (and
scipy) on the CPU."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from test_lpips import _random_net

from qed_splatter_tpu import metrics as jmetrics
from qed_splatter_tpu.ops.lpips import LPIPS as JLPIPS
from qed_splatter_tpu.ops.lpips import _ARCH
from qed_splatter_tpu_torch import metrics
from qed_splatter_tpu_torch.ops.knn import knn, nn_distances
from qed_splatter_tpu_torch.ops.lpips import LPIPS


def _clouds(case):
    rng = np.random.default_rng({"near": 1, "clustered": 2,
                                 "disjoint": 3}[case])
    if case == "near":
        recon = rng.normal(size=(800, 3))
        ref = recon + rng.normal(scale=0.03, size=recon.shape)
    elif case == "clustered":
        ref = np.concatenate([rng.normal(scale=0.01, size=(900, 3)),
                              rng.normal(loc=5.0, scale=2.0, size=(60, 3))])
        recon = rng.uniform(-3, 8, (400, 3))
    else:
        ref = rng.normal(size=(700, 3))
        recon = rng.normal(size=(300, 3)) + 40.0
    return recon.astype(np.float32), ref.astype(np.float32)


@pytest.mark.parametrize("case", ["near", "clustered", "disjoint"])
def test_pd_metrics_match_jax_and_scipy(case):
    recon, ref = _clouds(case)
    acc = metrics.calculate_accuracy(recon, ref)
    cmp_ = metrics.calculate_completeness(recon, ref)
    assert acc == pytest.approx(jmetrics.calculate_accuracy(recon, ref),
                                rel=1e-6)
    assert cmp_ == jmetrics.calculate_completeness(recon, ref)
    d1, _ = cKDTree(ref).query(recon)
    d2, _ = cKDTree(recon).query(ref)
    assert acc == pytest.approx(np.percentile(d1, 90), rel=1e-5)
    assert cmp_ == pytest.approx(np.sum(d2 < 0.05) / len(d2) * 100.0,
                                 rel=1e-6)
    assert metrics.PDMetrics()(recon, ref) == (acc, cmp_)
    assert metrics.calculate_accuracy(recon, ref, percentile=50) \
        == pytest.approx(np.percentile(d1, 50), rel=1e-5)


def test_nn_distances_hold_at_room_coordinates():
    """Short distances between points a few metres from the origin: the
    plain version (coordinate differences) holds to scipy at rtol 1e-5, the
    |q|^2 - 2 q.r + |r|^2 expansion does not."""
    rng = np.random.default_rng(4)
    ref = rng.uniform(-2.2, 2.2, (3000, 3)).astype(np.float32)
    ref[:, 2] += 3.0
    q = (ref[:1000] + rng.normal(scale=0.002, size=(1000, 3))).astype(
        np.float32)
    want, _ = cKDTree(ref).query(q)
    got = nn_distances(torch.as_tensor(q), torch.as_tensor(ref), chunk=256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    expansion, _ = knn(torch.as_tensor(q), torch.as_tensor(ref), k=1)
    assert np.abs(expansion[:, 0].numpy() - want).max() > 1e-4
    assert nn_distances(torch.zeros(3, 3), torch.zeros(0, 3)).isinf().all()
    assert nn_distances(torch.zeros(0, 3), torch.ones(4, 3)).shape == (0,)


def test_mean_angular_error_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    a = rng.normal(size=(20, 3)).astype(np.float32)
    b = rng.normal(size=(20, 3)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[0] = a[0]
    got = metrics.mean_angular_error(torch.as_tensor(a), torch.as_tensor(b))
    want = jmetrics.mean_angular_error(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _images(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, 0.1, img0.shape), 0, 1).astype(
        np.float32)
    return img0, img1


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
@pytest.mark.parametrize("normalize", [False, True])
def test_lpips_matches_jax(net_type, normalize):
    convs, biases, heads = _random_net(net_type)
    img0, img1 = _images(1)
    got = float(LPIPS(convs, biases, heads, net_type=net_type,
                      normalize=normalize)(torch.as_tensor(img0),
                                           torch.as_tensor(img1)))
    want = float(JLPIPS(convs, biases, heads, net_type=net_type,
                        normalize=normalize)(img0, img1))
    assert got == pytest.approx(want, rel=1e-4)
    assert got > 0
    same = LPIPS(convs, biases, heads, net_type=net_type)(
        torch.as_tensor(img0), torch.as_tensor(img0))
    assert abs(float(same)) < 1e-6


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
def test_rgb_metrics_lpips_from_npz(tmp_path, monkeypatch, net_type):
    convs, biases, heads = _random_net(net_type, seed=4)
    data = {}
    for (idx, _, _), w, b in zip(_ARCH[net_type]["convs"], convs, biases):
        data[f"net.features.{idx}.weight"] = w
        data[f"net.features.{idx}.bias"] = b
    for k, h in enumerate(heads):
        data[f"lin{k}.model.1.weight"] = h
    path = tmp_path / "lpips.npz"
    np.savez(path, **data)
    assert LPIPS.from_npz(str(path)).net_type == net_type
    img0, img1 = _images(5, 48, 64)
    want = jmetrics.RGBMetrics(lpips_weights=str(path))(img0, img1)
    got = metrics.RGBMetrics(lpips_weights=str(path))(
        torch.as_tensor(img0), torch.as_tensor(img1))
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-4)
    np.testing.assert_allclose([float(got[0]), float(got[1])],
                               [float(want[0]), float(want[1])], rtol=1e-5)
    # the environment variable, as in the JAX package
    monkeypatch.setenv("QED_LPIPS_WEIGHTS", str(path))
    assert metrics.RGBMetrics().has_lpips
    monkeypatch.delenv("QED_LPIPS_WEIGHTS")
    rgb = metrics.RGBMetrics()
    assert not rgb.has_lpips
    assert np.isnan(float(rgb(torch.as_tensor(img0),
                              torch.as_tensor(img1))[2]))
