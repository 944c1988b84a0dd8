"""PyTorch port vs the JAX package: configs, camera, knn, gaussians.

Inputs come from numpy with a seed and go through both packages; the port
runs on the CPU (plain PyTorch)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu import configs as jconfigs
from qed_splatter_tpu.models import gaussians as jg
from qed_splatter_tpu.ops.camera import get_viewmat as jviewmat
from qed_splatter_tpu.ops.knn import knn as jknn
from qed_splatter_tpu.ops.knn import mean_knn_distance as jmean_knn
from qed_splatter_tpu.testing import orbit_c2w_opengl as jorbit
from qed_splatter_tpu_torch import configs as tconfigs
from qed_splatter_tpu_torch.models import gaussians as tg
from qed_splatter_tpu_torch.ops.camera import get_viewmat as tviewmat
from qed_splatter_tpu_torch.ops.knn import knn as tknn
from qed_splatter_tpu_torch.ops.knn import mean_knn_distance as tmean_knn
from qed_splatter_tpu_torch.testing import orbit_c2w_opengl as torbit


@pytest.mark.parametrize("name", ["ModelConfig", "AdamConfig", "DataConfig",
                                  "TrainerConfig"])
def test_configs_field_for_field(name):
    jc = getattr(jconfigs, name)()
    tc = getattr(tconfigs, name)()
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    if name == "TrainerConfig":  # nested configs compare by their own fields
        for key in ("model", "data"):
            jf[key] = dataclasses.asdict(jf[key])
            tf[key] = dataclasses.asdict(tf[key])
        jf["optimizers"] = {k: dataclasses.asdict(v)
                            for k, v in jf["optimizers"].items()}
        tf["optimizers"] = {k: dataclasses.asdict(v)
                            for k, v in tf["optimizers"].items()}
    assert jf == tf


@pytest.mark.parametrize("az,el", [(0.0, 0.1), (1.3, -0.4), (4.0, 0.7)])
def test_orbit_and_viewmat_match(az, el):
    c2w = jorbit(2.5, az, el, (0.1, -0.2, 3.0))
    np.testing.assert_array_equal(torbit(2.5, az, el, (0.1, -0.2, 3.0)), c2w)
    # a [3, 4] pose and a batch of [4, 4] poses
    for pose in (c2w[:3], np.stack([c2w, jorbit(1.0, az + 1, el, (0, 0, 3))])):
        want = np.asarray(jviewmat(jnp.asarray(pose)))
        got = tviewmat(torch.as_tensor(pose)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def _mean_knn_oracle(pts, k=3):
    """float64 mean distance to the k nearest OTHER points."""
    d = np.linalg.norm(pts[:, None, :].astype(np.float64) - pts[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return np.sort(d, axis=1)[:, :k].mean(1)


def test_knn_matches():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    q = rng.normal(size=(90, 3)).astype(np.float32)
    jd, ji = jknn(jnp.asarray(q), jnp.asarray(pts), k=4, chunk=32)
    td, ti = tknn(torch.as_tensor(q), torch.as_tensor(pts), k=4, chunk=32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_mean_knn_distance_excludes_self():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    pts[5] = pts[6]                     # a duplicate finds its twin at 0
    got = tmean_knn(torch.as_tensor(pts), chunk=128).numpy()
    np.testing.assert_allclose(got, _mean_knn_oracle(pts), atol=1e-5)
    # The JAX package masks self-distances by d^2 <= 1e-12, and for ~12% of
    # points the expansion's rounding leaves the self-distance above that,
    # so their own ~0 distance counts as a neighbour (ROADMAP queue 3).
    # (It also masks a duplicate's twin at distance 0.) Elsewhere they agree.
    want = np.asarray(jmean_knn(jnp.asarray(pts), chunk=128))
    jax_ok = np.abs(want - _mean_knn_oracle(pts)) <= 1e-5
    assert jax_ok.mean() > 0.8
    np.testing.assert_allclose(got[jax_ok], want[jax_ok], atol=1e-5)


def test_from_jax_arrays_round_trip():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    rgb = (rng.uniform(0, 1, (300, 3)) * 255).astype(np.uint8)
    jp = jg.init_from_points(pts, rgb, sh_degree=2, capacity=512)
    arrays = {f: np.asarray(getattr(jp, f)) for f in tg.FIELDS}
    tp = tg.from_jax_arrays(arrays, device="cpu")
    assert tp.capacity == 512 and tp.sh_degree == 2
    for f in tg.FIELDS:
        got = getattr(tp, f)
        assert got.dtype == torch.from_numpy(arrays[f].copy()).dtype
        np.testing.assert_array_equal(got.numpy(), arrays[f])
    assert int(tp.num_alive()) == int(jp.num_alive())


def test_init_from_points_matches_except_quats():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    rgb = (rng.uniform(0, 1, (400, 3)) * 255).astype(np.uint8)
    jp = jg.init_from_points(pts, rgb, sh_degree=3, capacity_headroom=1.5)
    tp = tg.init_from_points(pts, rgb, sh_degree=3, capacity_headroom=1.5,
                             device="cpu")
    assert tp.capacity == jp.capacity
    for f in ("means", "opacities", "features_dc", "features_rest",
              "alive"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-5,
                                   err_msg=f)
    # scales = log(mean 3-NN distance of the OTHER points); compared with
    # JAX only on the rows its self-exclusion fault spares (ROADMAP queue 3)
    want = np.log(np.maximum(_mean_knn_oracle(pts), 1e-7))[:, None]
    got = tp.scales.numpy()
    np.testing.assert_allclose(got[:400], want.repeat(3, 1), atol=1e-5)
    jscales = np.asarray(jp.scales)
    jax_ok = np.abs(jscales[:400, 0] - want[:, 0]) <= 1e-5
    assert jax_ok.mean() > 0.8
    np.testing.assert_allclose(got[:400][jax_ok], jscales[:400][jax_ok],
                               atol=1e-5)
    np.testing.assert_array_equal(got[400:], jscales[400:])
    # quats: a torch.Generator stream, so only their law is shared
    q = tp.quats.numpy()
    assert q.shape == (jp.capacity, 4)
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    again = tg.init_from_points(pts, rgb, sh_degree=3, capacity_headroom=1.5,
                                device="cpu")
    np.testing.assert_array_equal(again.quats.numpy(), q)  # seeded


def test_rgb_to_sh_dc_inverts():
    rgb = torch.linspace(0, 1, 7)
    np.testing.assert_allclose(tg.sh_dc_to_rgb(tg.rgb_to_sh_dc(rgb)).numpy(),
                               rgb.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        tg.rgb_to_sh_dc(rgb).numpy(),
        np.asarray(jg.rgb_to_sh_dc(jnp.asarray(rgb.numpy()))), atol=1e-6)
