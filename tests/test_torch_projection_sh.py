"""PyTorch port vs the JAX package: EWA projection and SH colours."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.ops.projection import project_gaussians as jproj
from qed_splatter_tpu.ops.sh import degree_band_mask as jmask
from qed_splatter_tpu.ops.sh import eval_sh_colors as jsh
from qed_splatter_tpu.testing import random_scene, simple_camera
from qed_splatter_tpu_torch.ops.projection import project_gaussians as tproj
from qed_splatter_tpu_torch.ops.sh import degree_band_mask as tmask
from qed_splatter_tpu_torch.ops.sh import eval_sh_colors as tsh

W, H = 96, 64


def _scene_with_faults(seed):
    s = random_scene(n=512, seed=seed, scale_range=(0.005, 0.4))
    s["means"][:3] = [np.nan, 0, 3]          # non-finite rows are contained
    s["scales"][3] = [np.inf, 0.1, 0.1]
    s["quats"][4:8] = 0.0                    # zero quats normalize safely
    s["means"][8] = [0.0, 0.0, -1.0]         # behind the camera
    s["scales"][9] = [2.0, 1e-4, 1e-4]       # needle
    return s


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_projection_matches(antialiased, seed):
    s = _scene_with_faults(seed)
    vm, K = simple_camera(W, H, 70.0)
    # a rotated camera too: two cameras in one call
    c, sn = np.cos(0.3), np.sin(0.3)
    vm2 = vm[0].copy()
    vm2[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
    vm = np.stack([vm[0], vm2])
    K = np.concatenate([K, K])
    args = [s["means"], s["quats"], s["scales"], vm, K]
    j = jproj(*map(jnp.asarray, args), W, H, antialiased=antialiased)
    t = tproj(*map(torch.as_tensor, args), W, H, antialiased=antialiased)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert t.radii.dtype == torch.int32
    ok = np.asarray(j.valid)
    for f in ("means2d", "depths", "conics", "compensations"):
        a, b = getattr(t, f).numpy()[ok], np.asarray(getattr(j, f))[ok]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)
    # non-finite rows render nowhere; everything stays finite
    assert (t.radii.numpy()[:, :4] == 0).all()
    assert np.isfinite(t.conics.numpy()).all()


@pytest.mark.parametrize("max_degree,active", [(0, 0), (1, 1), (2, 1),
                                               (3, 0), (3, 2), (3, 3)])
def test_sh_colors_match(max_degree, active):
    rng = np.random.default_rng(max_degree * 10 + active)
    k = (max_degree + 1) ** 2
    coeffs = rng.normal(0, 0.5, (300, k, 3)).astype(np.float32)
    means = rng.normal(0, 1, (300, 3)).astype(np.float32)
    means[0] = [0.5, -0.25, 2.0]             # exactly at the camera
    campos = np.array([0.5, -0.25, 2.0], np.float32)
    j = jsh(jnp.asarray(coeffs), jnp.asarray(means), jnp.asarray(campos),
            jnp.asarray(active), max_degree)
    t = tsh(torch.as_tensor(coeffs), torch.as_tensor(means),
            torch.as_tensor(campos), torch.tensor(active), max_degree)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(tmask(active, max_degree).numpy(),
                                  np.asarray(jmask(active, max_degree)))
