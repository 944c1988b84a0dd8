"""Autograd through the port's projection, SH and camera-opt against JAX's
gradients on the same inputs, and the NaN containment: no NaN gradient
from a zero quaternion, a non-finite parameter row or a point behind the
camera.

Tolerance: rtol 1e-4 with an atol of 1e-5 of each gradient's max |value|.
Both sides run the same float32 formulas; the sums come in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.models import camera_opt as jcam
from qed_splatter_tpu.ops.projection import project_gaussians as jproj
from qed_splatter_tpu.ops.projection import quat_to_rotmat as jrotmat
from qed_splatter_tpu.ops.sh import eval_sh_colors as jsh
from qed_splatter_tpu.testing import random_scene
from qed_splatter_tpu_torch.models import camera_opt as tcam
from qed_splatter_tpu_torch.ops.projection import project_gaussians as tproj
from qed_splatter_tpu_torch.ops.projection import quat_to_rotmat as trotmat
from qed_splatter_tpu_torch.ops.sh import eval_sh_colors as tsh

W, H = 64, 48


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), f"{name}: non-finite gradient"
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=name)


def _grads_both(jfn, tfn, inputs):
    """Gradients of the same scalar function in both packages."""
    jg = jax.grad(jfn, argnums=tuple(range(len(inputs))))(
        *map(jnp.asarray, inputs))
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    tg = torch.autograd.grad(tfn(*leaves), leaves)
    return jg, tg


def _camera():
    rng = np.random.default_rng(7)
    ang = rng.uniform(-0.2, 0.2, 3)
    c, s = np.cos(ang), np.sin(ang)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    vm = np.eye(4)
    vm[:3, :3] = rx @ ry
    vm[:3, 3] = rng.uniform(-0.3, 0.3, 3)
    K = np.array([[55.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
    return vm[None].astype(np.float32), K[None].astype(np.float32)


@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_grads_match_jax(antialiased):
    """Means, quats and scales gradients through means2d, depths, conics and
    compensations. Rows 0-3 are hostile: a zero quaternion, a NaN mean, an
    inf scale and a point behind the camera."""
    s = random_scene(n=48, seed=4)
    means, quats, scales = s["means"], s["quats"], s["scales"]
    quats[0] = 0.0
    means[1, 0] = np.nan
    scales[2, 1] = np.inf
    means[3] = (0.1, 0.2, -2.0)
    vm, K = _camera()
    rng = np.random.default_rng(1)
    wts = [rng.normal(size=shape).astype(np.float32)
           for shape in ((1, 48, 2), (1, 48), (1, 48, 3), (1, 48))]

    def jloss(m, q, sc):
        r = jproj(m, q, sc, jnp.asarray(vm), jnp.asarray(K), W, H,
                  antialiased=antialiased)
        terms = (r.means2d, r.depths, r.conics, r.compensations)
        return sum((t * w).sum() for t, w in zip(terms, wts))

    def tloss(m, q, sc):
        r = tproj(m, q, sc, torch.tensor(vm), torch.tensor(K), W, H,
                  antialiased=antialiased)
        terms = (r.means2d, r.depths, r.conics, r.compensations)
        return sum((t * torch.tensor(w)).sum() for t, w in zip(terms, wts))

    jg, tg = _grads_both(jloss, tloss, [means, quats, scales])
    for name, a, b in zip(("means", "quats", "scales"), tg, jg):
        _close(a, b, name)
    # the contained rows get exact zero gradients
    for name, g in zip(("means", "quats", "scales"), tg):
        assert not g[1:3].any(), f"{name}: non-finite row leaked"


def test_zero_quat_gradients_finite():
    quats = np.array([[1.0, 0, 0, 0], [0.0, 0, 0, 0], [0.3, -0.2, 0.5, 0.1]],
                     np.float32)
    jg, tg = _grads_both(lambda q: jnp.sum(jrotmat(q) ** 2),
                         lambda q: torch.sum(trotmat(q) ** 2), [quats])
    assert torch.isfinite(tg[0]).all()
    _close(tg[0], jg[0], "quats")


@pytest.mark.parametrize("active", [1, 3])
def test_sh_grads_match_jax(active):
    """Coefficient, mean and camera-position gradients of degree-3 SH at an
    active degree; row 0 sits on the camera (a zero view direction)."""
    rng = np.random.default_rng(active)
    n = 40
    coeffs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    campos = np.array([0.2, -0.1, -2.0], np.float32)
    means[0] = campos
    wts = rng.normal(size=(n, 3)).astype(np.float32)
    jg, tg = _grads_both(
        lambda c, m, p: jnp.sum(jsh(c, m, p, active, 3) * wts),
        lambda c, m, p: torch.sum(tsh(c, m, p, active, 3) * torch.tensor(
            wts)),
        [coeffs, means, campos])
    for name, a, b in zip(("coeffs", "means", "campos"), tg, jg):
        _close(a, b, name)


def test_camera_opt_grads_match_jax():
    """exp_so3 (the small-angle branch at zero deltas, the Rodrigues branch
    elsewhere), apply_camera_opt and the regularizer: values and delta
    gradients."""
    rng = np.random.default_rng(3)
    deltas = rng.normal(0, 0.05, (4, 6)).astype(np.float32)
    deltas[0] = 0.0
    deltas[1, 3:] = 1e-8
    c2w = np.stack([np.eye(4, dtype=np.float32)] * 4)
    c2w[:, :3, 3] = rng.normal(size=(4, 3))
    wts = rng.normal(size=(4, 4, 4)).astype(np.float32)

    def jloss(d):
        return (jnp.sum(jcam.apply_camera_opt(jnp.asarray(c2w), d) * wts)
                + jcam.camera_opt_regularizer(d))

    def tloss(d):
        return (torch.sum(tcam.apply_camera_opt(torch.tensor(c2w), d)
                          * torch.tensor(wts))
                + tcam.camera_opt_regularizer(d))

    jg, tg = _grads_both(jloss, tloss, [deltas])
    _close(tg[0], jg[0], "deltas")
    np.testing.assert_allclose(
        tcam.exp_so3(torch.tensor(deltas[:, 3:])).numpy(),
        np.asarray(jcam.exp_so3(jnp.asarray(deltas[:, 3:]))), atol=1e-6)
    np.testing.assert_allclose(
        float(tloss(torch.tensor(deltas))), float(jloss(jnp.asarray(deltas))),
        rtol=1e-6)
