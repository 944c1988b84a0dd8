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
