"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs a CUDA GPU and nvcc; each test skips without one. On a GPU machine:
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _slabs(gen, t, d, k, ntx):
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")

    tid = torch.arange(t, device="cuda")
    ox = ((tid % ntx) * 16).float()[:, None]
    oy = ((tid // ntx) * 16).float()[:, None]
    means = torch.stack([ox + u(-10, 26, t, k), oy + u(-10, 26, t, k)], 1)
    s = u(0.8, 5.0, t, k)
    conics = torch.stack([1 / s ** 2, torch.zeros_like(s), 1 / s ** 2], 1)
    colors = u(0, 1, t, d, k)
    opac = u(0.05, 0.9, t, 1, k)
    return [x.contiguous() for x in (means, conics, colors, opac)]


@pytest.mark.parametrize("d,k", [(3, 256), (4, 256), (4, 100)])
def test_composite_kernel_matches_plain(gen, d, k):
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    slabs = _slabs(gen, 60, d, k, 10)
    before = rp.COMPOSITE.launches
    out, acc = rp.composite_tiles(*slabs, 10)
    torch.cuda.synchronize()
    assert rp.COMPOSITE.launches == before + 1
    ro, ra = rp.composite_tiles_ref(*slabs, 10)
    assert float((out - ro).abs().max()) <= TOL
    assert float((acc - ra).abs().max()) <= TOL


def test_chunked_composite_kernel_matches_plain(gen):
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, k = 60, 2 * rp.K_CHUNK + 300
    slabs = _slabs(gen, t, 4, k, 10)
    slabs[3] *= 0.1
    counts = torch.randint(1, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    out, acc = rp.composite_tiles_chunked(*slabs, 10, tile_counts=counts,
                                          chunks_run=runs)
    ro, ra = rp.composite_tiles_ref(*slabs, 10, tile_counts=counts,
                                    k_chunk=rp.K_CHUNK, chunks_run=runs_ref)
    assert float((out - ro).abs().max()) <= TOL
    assert float((acc - ra).abs().max()) <= TOL
    assert torch.equal(runs, runs_ref)


def test_slab_gather_kernel_exact(gen):
    from qed_splatter_tpu_torch.ops import tiles

    m = 100_000
    keys = torch.sort(torch.randint(0, 1 << 40, (m,), generator=gen,
                                    device="cuda")).values
    starts = torch.sort(torch.randint(0, m, (500,), generator=gen,
                                      device="cuda")).values
    starts[:3] = torch.tensor([-7, m, m + 9], device="cuda")
    for k in (1, 128, 333, 2048):
        assert torch.equal(tiles.slab_gather(keys, starts, k, -1),
                           tiles.slab_gather_ref(keys, starts, k, -1))


def test_render_kernels_match_plain_path(gen):
    import dataclasses

    from qed_splatter_tpu_torch.configs import ModelConfig
    from qed_splatter_tpu_torch.models.gaussians import init_from_points
    from qed_splatter_tpu_torch.models.splatfacto import render
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl, \
        orbit_intrinsics

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    params = init_from_points(pts, None, capacity=4096)
    cfg = ModelConfig(max_per_tile=256)
    c2w = orbit_c2w_opengl(3.0, 0.3, 0.1)
    K = orbit_intrinsics(200, 120)
    out = render(params, c2w, K, 200, 120, cfg)
    plain = render(params, c2w, K, 200, 120,
                   dataclasses.replace(cfg, use_pallas=False))
    assert float((out.rgb - plain.rgb).abs().max()) <= TOL
    assert float((out.accumulation - plain.accumulation).abs().max()) <= TOL


def _bwd_rel_err(got, want):
    """Max error of each gradient over its max |value| (the kernel's warp
    shuffles and the plain autograd sum in other orders)."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
               for g, w in zip(got, want))


@pytest.mark.parametrize("d,k", [(3, 256), (4, 256), (4, 100)])
def test_composite_bwd_kernel_matches_plain(gen, d, k):
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t = 60
    slabs = _slabs(gen, t, d, k, 10)
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    runs = torch.ones(t, dtype=torch.int32, device="cuda")
    before = rp.COMPOSITE_BWD.launches
    got = rp.composite_tiles_bwd(*slabs, gout, gacc, 10, 16, 0, runs)
    torch.cuda.synchronize()
    assert rp.COMPOSITE_BWD.launches == before + 1
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, 10)
    assert _bwd_rel_err(got, want) <= 1e-3


def test_chunked_composite_bwd_kernel_matches_plain(gen):
    """Three chunks: tiles that stop by count or saturation get exact zero
    gradients past their last composited chunk."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, k = 60, 2 * rp.K_CHUNK + 300
    slabs = _slabs(gen, t, 4, k, 10)
    slabs[3] *= 0.1
    counts = torch.randint(1, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    leaves = [x.clone().requires_grad_(True) for x in slabs]
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    out, acc = rp.composite_tiles_chunked(*leaves, 10, tile_counts=counts,
                                          chunks_run=runs)
    gout = torch.randn_like(out)
    gacc = torch.randn_like(acc)
    before = rp.COMPOSITE_BWD.variant_launches.get("chunked", 0)
    got = torch.autograd.grad((out, acc), leaves, (gout, gacc))
    torch.cuda.synchronize()
    assert rp.COMPOSITE_BWD.variant_launches["chunked"] == before + 1
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, 10,
                                      k_chunk=rp.K_CHUNK, chunks_run=runs)
    assert _bwd_rel_err(got, want) <= 1e-3
    assert 0 < int((runs < 3).sum()) < t
    for g in got:
        for i, r in enumerate(runs.tolist()):
            assert not g[i, :, r * rp.K_CHUNK:].any()


def test_train_step_kernels_match_plain_path(gen):
    """One training step's gradients, kernel path against plain path."""
    import dataclasses

    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.models.gaussians import init_from_points
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl, \
        orbit_intrinsics

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    params = init_from_points(pts, None, capacity=4096)
    # anisotropic, or the rotation has no effect and quats get no gradient
    params = params.replace(scales=params.scales + torch.as_tensor(
        rng.normal(0, 0.4, (4096, 3)), dtype=torch.float32, device="cuda"))
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(params, optims, num_cameras=1)
    batch = dict(c2w=orbit_c2w_opengl(3.0, 0.3, 0.1), K=orbit_intrinsics(
        200, 120), cam_idx=0,
        rgb=rng.uniform(0, 1, (120, 200, 3)).astype(np.float32),
        depth=rng.uniform(0.5, 4, (120, 200, 1)).astype(np.float32))
    cfg = ModelConfig(max_per_tile=256, background_color="black")
    got = make_train_step(cfg, optims, 200, 120, True).grads(state, batch,
                                                             None)
    want = make_train_step(dataclasses.replace(cfg, use_pallas=False),
                           optims, 200, 120, True).grads(state, batch, None)
    assert abs(float(got.loss) - float(want.loss)) <= 1e-5 * float(want.loss)
    for name in got.params:
        assert _bwd_rel_err([got.params[name]], [want.params[name]]) <= 1e-3
    assert _bwd_rel_err([got.camera_opt], [want.camera_opt]) <= 1e-3
    assert _bwd_rel_err([got.absgrad], [want.absgrad]) <= 1e-3
