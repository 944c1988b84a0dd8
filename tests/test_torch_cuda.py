"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs a CUDA GPU and nvcc; each test skips without one. On a GPU machine:
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import dataclasses

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


def _stack(slabs, tiles_, depth, ntx):
    """``depth`` slots of alpha 0.999 over the whole tile, in front."""
    tid = torch.arange(slabs[0].shape[0], device="cuda")
    slabs[0][tiles_, 0, :depth] = ((tid[tiles_] % ntx) * 16 + 8.0)[:, None]
    slabs[0][tiles_, 1, :depth] = ((tid[tiles_] // ntx) * 16 + 8.0)[:, None]
    slabs[1][tiles_, :, :depth] = torch.tensor(
        [1e-6, 0.0, 1e-6], device="cuda")[None, :, None]
    slabs[3][tiles_, 0, :depth] = 0.999


@pytest.mark.parametrize("d,k,top", [(4, 256, 100), (3, 256, 256),
                                     (4, 100, 30), (1, 64, 64)])
def test_composite_kernel_stops_at_counts(gen, d, k, top):
    """With tile counts the kernel composites only the slots below each
    count (0 and counts above K included): it matches the plain version,
    and NaN in the slots at and past the count is never read."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t = 60
    slabs = _slabs(gen, t, d, k, 10)
    counts = torch.randint(0, top + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[:3] = torch.tensor([0, k, k + 50], device="cuda",
                              dtype=torch.int32)
    out, acc, _, _ = rp.composite_tiles_fwd(*slabs, 10, 16, counts)
    torch.cuda.synchronize()
    ro, ra = rp.composite_tiles_ref(*slabs, 10, tile_counts=counts)
    assert float((out - ro).abs().max()) <= TOL
    assert float((acc - ra).abs().max()) <= TOL
    assert not out[0].any() and not acc[0].any()
    # what the binning leaves there (opacity 0) composites to the same
    slot = torch.arange(k, device="cuda")[None, None, :]
    past = slot >= counts[:, None, None]
    padded = slabs[:3] + [torch.where(past, 0.0, slabs[3])]
    po, pa = rp.composite_tiles(*padded, 10)
    assert torch.equal(po, out) and torch.equal(pa, acc)
    bad = [torch.where(past, float("nan"), x) for x in slabs[:3]]
    no, na, _, _ = rp.composite_tiles_fwd(*bad, padded[3], 10, 16, counts)
    assert torch.equal(no, out) and torch.equal(na, acc)


@pytest.mark.parametrize("chunked", [False, True])
def test_composite_kernel_hands_over_transmittance(gen, chunked):
    """``t_last`` and ``cut`` from the forward kernel equal the plain
    version's slot-by-slot product bit for bit: under 24-deep opaque stacks
    (T falls below 1e-30 inside the stack), with tile counts, chunked and
    not; the backward fed by them equals the one that recomputes them."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, d, ntx = 60, 4, 10
    k = 2 * rp.K_CHUNK + 300 if chunked else 256
    slabs = _slabs(gen, t, d, k, ntx)
    if chunked:
        slabs[3] *= 0.1
    _stack(slabs, slice(0, 20), 24, ntx)
    counts = torch.randint(1, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[:4] = torch.tensor([k, 30, 5, k + 9], device="cuda",
                              dtype=torch.int32)
    k_chunk = rp.K_CHUNK if chunked else 0
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    got = rp.composite_tiles_fwd(*slabs, ntx, 16, counts, k_chunk, runs,
                                 tail=True)
    want = rp.composite_tiles_ref(*slabs, ntx, 16, counts, k_chunk,
                                  runs_ref, tail=True)
    torch.cuda.synchronize()
    assert torch.equal(runs, runs_ref)
    assert float((got[0] - want[0]).abs().max()) <= TOL
    assert torch.equal(got[2], want[2]), "t_last"
    assert torch.equal(got[3], want[3]), "cut"
    n_run = rp.slots_run(t, k, k_chunk, runs, counts, "cuda")
    assert bool((got[3][0] < n_run[0]).all()) and bool(
        (got[3][2] == 5).all())
    assert bool((got[2] >= rp.TRANS_MIN).all())
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    fed = rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, k_chunk, runs,
                                 counts, got[2], got[3])
    with pytest.raises(ValueError):     # nothing recomputes the handoff
        rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, k_chunk, runs,
                               counts, None, None)
    ref = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx,
                                     k_chunk=k_chunk, chunks_run=runs,
                                     tile_counts=counts)
    assert _bwd_rel_err(fed, ref) <= 1e-3


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
    # a view whose first key is not 16-byte aligned
    assert torch.equal(tiles.slab_gather(keys[1:], starts, 256, 7),
                       tiles.slab_gather_ref(keys[1:], starts, 256, 7))


def _stacked(tiles_counts, seed, ntx=6, nty=4):
    """Splats of radius 3 at tile centres, ``c`` on each tile ``t`` of
    ``tiles_counts`` ({t: c}); random depths."""
    rng = np.random.default_rng(seed)
    t = np.concatenate([np.full(c, t) for t, c in tiles_counts.items()])
    t = t[rng.permutation(t.size)]
    m2d = np.stack([(t % ntx) * 16 + 8.0, (t // ntx) * 16 + 8.0], 1)
    m2d += rng.uniform(-2, 2, m2d.shape)
    radii = np.full(t.size, 3, np.int32)
    return m2d.astype(np.float32), radii, rng.uniform(0.5, 9, t.size)


def _scene(n, seed, sr):
    from qed_splatter_tpu_torch.ops.projection import project_gaussians
    from qed_splatter_tpu_torch.testing import random_scene, simple_camera

    s = random_scene(n=n, seed=seed, scale_range=sr)
    vm, K = simple_camera(96, 64, 60.0)
    p = project_gaussians(*(torch.tensor(s[x]) for x in (
        "means", "quats", "scales")), torch.tensor(vm), torch.tensor(K),
        96, 64)
    return (p.means2d[0].numpy(), p.radii[0].to(torch.int32).numpy(),
            p.depths[0].numpy())


def _culled(inputs):
    m2d, radii, depths = inputs
    return m2d, np.zeros_like(radii), depths


# name: (inputs, bin_gaussians keywords); 96x64 (6x4 tiles); the kernels'
# row block is 1024 depth ranks
BINNING_CASES = {
    # tests/test_torch_tiles.py's cases: small splats, big ones over the
    # pair budget with an auto-sized and a 16-row overflow table, a K cap
    "small": (lambda: _scene(2048, 0, (0.02, 0.12)), dict(max_per_tile=128)),
    "big": (lambda: _scene(1500, 1, (0.1, 0.6)), dict(max_per_tile=128)),
    "overflow_short": (lambda: _scene(1500, 1, (0.1, 0.6)), dict(
        max_per_tile=256, small_tiles_per_gaussian=2, overflow_slots=16)),
    "few": (lambda: _scene(300, 2, (0.02, 0.3)), dict(
        max_per_tile=64, small_tiles_per_gaussian=4)),
    # tile 3 reaches K = 2048 exactly; tile 9 crosses it inside a row block
    "reach_k": (lambda: _stacked({3: 2048, 9: 3000, 15: 100}, 4),
                dict(max_per_tile=2048, small_tiles_per_gaussian=64)),
    # counts far above K + 1023
    "far_above": (lambda: _stacked({0: 20_000, 23: 64}, 5),
                  dict(max_per_tile=64, small_tiles_per_gaussian=64)),
    "culled": (lambda: _culled(_scene(256, 3, (0.02, 0.12))),
               dict(max_per_tile=128)),
    # bboxes over the whole budget of 16 cells, overflow rows for all
    "over_budget": (lambda: _scene(1500, 1, (0.1, 0.6)), dict(
        max_per_tile=128, max_tiles_per_gaussian=16,
        small_tiles_per_gaussian=4)),
    # the pair budget is the whole budget: no overflow table
    "budget_64": (lambda: _scene(1500, 1, (0.1, 0.6)), dict(
        max_per_tile=256, small_tiles_per_gaussian=64)),
}


@pytest.mark.parametrize("case", [*BINNING_CASES, "graph_replay"])
def test_binning_kernels_match_plain_path(gen, case):
    """``csrc/binning.cu`` against the plain version, integer for integer:
    the whole binning against ``use_pallas=False`` on the card, and the
    kernel set against the plain version on CPU tensors from the same
    depth-ordered rows; one launch of each kernel a binning. The graph case
    captures a binning and replays it on other inputs of the same shape."""
    from qed_splatter_tpu_torch.ops import tiles

    fields = ("order", "tile_counts", "num_truncated", "tile_ranks",
              "tile_lists")
    name = "small" if case == "graph_replay" else case
    make, kw = BINNING_CASES[name]
    args = [torch.as_tensor(x, device="cuda") for x in make()]
    args[2] = args[2].float()
    if case == "graph_replay":
        static = [a.clone() for a in args]
        tiles.bin_gaussians(*static, 96, 64, **kw)       # builds and loads
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = tiles.bin_gaussians(*static, 96, 64, **kw)
        other = [torch.as_tensor(x, device="cuda")
                 for x in _scene(2048, 7, (0.05, 0.3))]
        for s, a in zip(static, other):
            s.copy_(a.to(s.dtype))
        graph.replay()
        torch.cuda.synchronize()
        args = static
    else:
        before = [(k.launches, k.variant_launches.get("overflow", 0))
                  for k in tiles.BIN_KERNELS]
        got = tiles.bin_gaussians(*args, 96, 64, **kw)
        torch.cuda.synchronize()
        overflow = kw.get("small_tiles_per_gaussian", 8) < kw.get(
            "max_tiles_per_gaussian", 64)
        for k, (n, v) in zip(tiles.BIN_KERNELS, before):
            assert k.launches == n + 1, k.symbol
            assert k.variant_launches.get("overflow", 0) == v + (
                overflow and k in (tiles.BIN_COUNT, tiles.BIN_PLACE))
    want = tiles.bin_gaussians(*args, 96, 64, use_pallas=False, **kw)
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the kernel set against the plain version on the CPU, same rows
    n = args[0].shape[0]
    tpg = kw.get("max_tiles_per_gaussian", 64)
    small = min(kw.get("small_tiles_per_gaussian", 8), tpg)
    slots = kw.get("overflow_slots", 0) or max(1024, n // 16)
    n_big = min(slots, n) if tpg > small else 0
    cols = torch.cat([args[0], args[1][:, None].float()], -1)[got.order]
    spec = (16, 6, 4, kw["max_per_tile"], tpg, small, n_big)
    for a, b in zip(tiles._bin_kernels(cols, *spec),
                    tiles._bin_dense(cols.cpu(), *spec)):
        assert torch.equal(a.cpu(), b)
    counts, k = got.tile_counts, kw["max_per_tile"]
    if name == "reach_k":
        assert counts[3] == k and counts[9] > k
    if name == "far_above":
        assert counts[0] > k + tiles.ROW_BLOCK
    if name in ("overflow_short", "over_budget"):
        assert int(got.num_truncated) > 0
    if name == "culled":
        assert int(counts.sum()) == 0 and bool((got.tile_ranks == -1).all())


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


def _bwd(slabs, gout, gacc, ntx, runs, counts):
    """The unchunked backward kernel, fed by the forward kernel's handoff."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t_last, cut = rp.composite_tiles_fwd(*slabs, ntx, 16, counts,
                                         tail=True)[2:]
    return rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, 0, runs,
                                  counts, t_last, cut)


@pytest.mark.parametrize("d,k", [(3, 256), (4, 256), (4, 100)])
def test_composite_bwd_kernel_matches_plain(gen, d, k):
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t = 60
    slabs = _slabs(gen, t, d, k, 10)
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    runs = torch.ones(t, dtype=torch.int32, device="cuda")
    before = rp.COMPOSITE_BWD.launches
    got = _bwd(slabs, gout, gacc, 10, runs, None)
    torch.cuda.synchronize()
    assert rp.COMPOSITE_BWD.launches == before + 1
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, 10)
    assert _bwd_rel_err(got, want) <= 1e-3


@pytest.mark.parametrize("d,k,top", [(4, 256, 100), (3, 256, 256),
                                     (4, 100, 30), (1, 64, 64)])
def test_composite_bwd_kernel_stops_at_counts(gen, d, k, top):
    """With tile counts the kernel replays only the slots below each count
    (0 and counts above K included) and writes exact zeros past them."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t = 60
    slabs = _slabs(gen, t, d, k, 10)
    counts = torch.randint(0, top + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[:3] = torch.tensor([0, k, k + 50], device="cuda",
                              dtype=torch.int32)
    slot = torch.arange(k, device="cuda")[None, None, :]
    slabs[3] = torch.where(slot < counts[:, None, None], slabs[3], 0.0)
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    runs = torch.ones(t, dtype=torch.int32, device="cuda")
    got = _bwd(slabs, gout, gacc, 10, runs, counts)
    torch.cuda.synchronize()
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, 10)
    assert _bwd_rel_err(got, want) <= 1e-3
    for g in got:
        assert not bool(torch.where(slot >= counts[:, None, None], g,
                                    0.0).any())


def test_composite_bwd_kernel_under_opaque_stacks(gen):
    """Tiles that start with 8 or 24 slots of alpha 0.999 over the whole
    tile (T down to 1e-72, below float32): the kernel stays finite and
    within the bar, and agrees with its plain algorithm."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, d, k, ntx = 60, 4, 256, 10
    slabs = _slabs(gen, t, d, k, ntx)
    _stack(slabs, slice(0, 20), 8, ntx)
    _stack(slabs, slice(20, 40), 24, ntx)
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    runs = torch.ones(t, dtype=torch.int32, device="cuda")
    got = _bwd(slabs, gout, gacc, ntx, runs, None)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx)
    plain = rp.composite_tiles_bwd_sweeps_ref(*slabs, gout, gacc, ntx)
    assert _bwd_rel_err(got, want) <= 1e-3
    assert _bwd_rel_err(got, plain) <= 1e-3


def test_chunked_composite_bwd_kernel_matches_plain(gen):
    """Three chunks: tiles that stop by count or saturation get exact zero
    gradients past their last composited chunk."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, k = 60, 2 * rp.K_CHUNK + 300
    slabs = _slabs(gen, t, 4, k, 10)
    slabs[3] *= 0.1
    counts = torch.randint(1, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    # slots at and past a tile's count are padding, as the binning leaves
    # them: the backward stops at the count
    slot = torch.arange(k, device="cuda")[None, None, :]
    slabs[3] = torch.where(slot < counts[:, None, None], slabs[3], 0.0)
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
        for i, (r, c) in enumerate(zip(runs.tolist(), counts.tolist())):
            assert not g[i, :, min(r * rp.K_CHUNK, c):].any()


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


def test_trainer_on_the_card_grows_and_launches_every_kernel(gen, tmp_path):
    """A short trainer run on the card: the capacity grows at the first
    refine, every kernel of the path launches, the losses stay finite."""
    import json

    from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
        TrainerConfig
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles
    from qed_splatter_tpu_torch.testing import write_room_dataset

    write_room_dataset(tmp_path / "room", num_frames=6, width=256,
                       height=168, sparse_ply=3000, workers=4)
    model = ModelConfig(num_downscales=1, resolution_schedule=15,
                        warmup_length=10, refine_every=10,
                        init_capacity_headroom=1.05, max_per_tile=256)
    cfg = TrainerConfig(max_num_iterations=30, steps_per_eval_image=0,
                        steps_per_eval_all_images=30, steps_per_save=0,
                        log_every=5, output_dir=str(tmp_path / "out"),
                        data=DataConfig(data=str(tmp_path / "room")),
                        model=model, steps_per_dispatch=1)
    trainer = Trainer(cfg)
    cap = trainer.state.params.capacity
    for kern in (rp.COMPOSITE, rp.COMPOSITE_BWD, *tiles.BIN_KERNELS):
        kern.reset()
    trainer.train()
    assert rp.COMPOSITE_BWD.launches == 30
    assert rp.COMPOSITE.launches >= 30
    assert all(k.launches == rp.COMPOSITE.launches for k in tiles.BIN_KERNELS)
    assert trainer.state.params.capacity >= 2 * cap
    rows = [json.loads(x) for x in open(trainer.run_dir / "metrics.jsonl")]
    assert all(np.isfinite(r["loss"]) for r in rows if r["split"] == "train")
    assert (trainer.run_dir / "splat.ply").exists()


def _witness(kern):
    """``kern`` built with the intrinsics in place of csrc/mixed.cuh's
    exact forms."""
    from qed_splatter_tpu_torch.cuda import CudaKernel

    return CudaKernel(kern.source, kern.symbol, kern.argtypes[:-1],
                      ("-DQED_MIX_WITNESS=1",))


@pytest.mark.parametrize("d,k,chunked,stack", [
    (3, 128, False, 0), (4, 256, False, 0), (3, 333, False, 0),
    (4, 2304, True, 0), (4, 256, False, 20), (4, 2304, True, 20),
    (4, 256, False, 128), (4, 2304, True, 128)])
def test_mixed_kernels_match_plain(gen, d, k, chunked, stack, monkeypatch):
    """The mixed_precision (bf16 operand) forward and backward kernels
    against their plain versions: the forward within TOL with the block
    sums of its handoff equal, the backward, fed by that handoff, against
    autograd of the plain mixed forward; tile counts below K, exact zeros
    past them; both bit-equal to their witness build (the intrinsics).
    ``stack``: a third of the tiles start with that many slots of alpha
    0.999 over the whole tile, so exp(E) underflows to 0 inside the first
    block (about 16 slots) and every term behind it is an exact zero: exact
    zeros from slot 17 on. A stack of 128 is an opaque block: its sum of
    rounded logs passes 2^24 units (|E| > 512), alone and inside chunk 1."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, ntx = 60, 10
    slabs = _slabs(gen, t, d, k, ntx)
    slabs[3] *= 0.5 if not chunked else 0.05
    counts = torch.randint(0, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[:3] = torch.tensor([0, 1, k], device="cuda", dtype=torch.int32)
    stacked = slice(3, 23)
    if stack:
        _stack(slabs, stacked, stack, ntx)
        counts[stacked] = k
    k_chunk = rp.K_CHUNK if chunked else 0
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    before = (rp.COMPOSITE_MIXED.launches, rp.COMPOSITE_BWD_MIXED.launches)
    out, acc, h = rp.composite_tiles_fwd_mixed(*slabs, ntx, 16, counts,
                                               k_chunk, runs, tail=True)
    ro, ra, hr = rp.composite_tiles_ref(*slabs, ntx, 16, counts, k_chunk,
                                        runs_ref, tail=True, mixed=True)
    assert float((out - ro).abs().max()) <= TOL
    assert float((acc - ra).abs().max()) <= TOL
    assert torch.equal(runs, runs_ref)
    n_run = rp.slots_run(t, k, k_chunk, runs, counts, "cuda")
    nb, _ = rp.mixed_shapes(k, k_chunk)
    blk = (torch.arange(nb, device="cuda") * rp.MIX_BLOCK)[None] < n_run[
        :, None]
    assert torch.equal(h.sums[blk], hr.sums[blk])
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    got = rp.composite_tiles_bwd_mixed(*slabs, gout, gacc, ntx, 16, k_chunk,
                                       runs, counts, h)
    torch.cuda.synchronize()
    assert (rp.COMPOSITE_MIXED.launches, rp.COMPOSITE_BWD_MIXED.launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(rp, "COMPOSITE_MIXED", _witness(rp.COMPOSITE_MIXED))
    monkeypatch.setattr(rp, "COMPOSITE_BWD_MIXED",
                        _witness(rp.COMPOSITE_BWD_MIXED))
    runs_w = torch.empty_like(runs)
    wo, wa, wh = rp.composite_tiles_fwd_mixed(*slabs, ntx, 16, counts,
                                              k_chunk, runs_w, tail=True)
    kc = k_chunk if chunked else k
    chk = (torch.arange(wh.trans.shape[1], device="cuda") * kc)[None] < n_run[
        :, None]
    assert torch.equal(wo, out) and torch.equal(wa, acc)
    assert torch.equal(runs_w, runs)
    for x, y, m in ((wh.offsets, h.offsets, blk), (wh.sums, h.sums, blk),
                    (wh.trans, h.trans, chk)):
        assert torch.equal(x[m], y[m])
    witness = rp.composite_tiles_bwd_mixed(*slabs, gout, gacc, ntx, 16,
                                           k_chunk, runs, counts, h)
    assert all(torch.equal(a, b) for a, b in zip(got, witness))
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, 16,
                                      k_chunk=k_chunk, chunks_run=runs,
                                      tile_counts=counts, mixed=True)
    assert _bwd_rel_err(got, want) <= 1e-3
    past = torch.arange(k, device="cuda")[None, None, :] >= counts[
        :, None, None].long()
    assert all(not bool(torch.where(past, g, 0.0).any()) for g in got)
    if stack >= 128:
        assert bool((h.sums[stacked, 0] < -(1 << 24)).all())
    if stack:
        assert bool((torch.exp(h.offsets[stacked, 1]) == 0).all())
        for g, w in zip(got, want):
            assert not bool(w[stacked, :, 17:].any())
            assert not bool(g[stacked, :, 17:].any())


def test_mixed_train_step_on_the_card(gen):
    """``mixed_precision`` trains through make_train_step on the card, through
    the mixed kernels only, within the bf16 envelope of the float32 step."""
    import dataclasses

    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.models.gaussians import init_from_points
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl, \
        orbit_intrinsics

    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    w, h = 200, 120
    batch = dict(c2w=torch.as_tensor(orbit_c2w_opengl(3.0, 0.3, 0.1),
                                     device="cuda"),
                 K=torch.as_tensor(orbit_intrinsics(w, h), device="cuda"),
                 cam_idx=0,
                 rgb=torch.rand((h, w, 3), generator=gen, device="cuda"),
                 depth=torch.rand((h, w, 1), generator=gen, device="cuda")
                 * 3 + 1)
    optims = GroupOptimizers(default_optimizers())
    cfg = ModelConfig(max_per_tile=256, background_color="black",
                      mixed_precision=True)
    state = init_train_state(init_from_points(pts, None, capacity=4096),
                             optims, num_cameras=1)
    step = make_train_step(cfg, optims, w, h, has_depth=True)
    before = (rp.COMPOSITE.launches, rp.COMPOSITE_MIXED.launches)
    gm = step.grads(state, batch, None)
    torch.cuda.synchronize()
    assert (rp.COMPOSITE.launches, rp.COMPOSITE_MIXED.launches) == (
        before[0], before[1] + 1)
    g32 = make_train_step(dataclasses.replace(cfg, mixed_precision=False),
                          optims, w, h, has_depth=True).grads(state, batch,
                                                              None)
    assert abs(float(gm.loss) - float(g32.loss)) <= 1e-3 * float(g32.loss)
    for g in ("means", "opacities", "features_dc"):
        scale = float(g32.params[g].abs().max())
        assert float((gm.params[g] - g32.params[g]).abs().max()) <= (
            5e-2 * scale)


def test_slab_gather_4_byte_kernel_exact(gen):
    """Kernel #6's port: the gather mode on int32 keys, odd and unaligned
    starts, a view whose first key is not 16-byte aligned."""
    from qed_splatter_tpu_torch.ops import tiles

    m = 100_000
    keys = torch.sort(torch.randint(0, 1 << 31, (m,), generator=gen,
                                    device="cuda")).values.to(torch.int32)
    starts = torch.sort(torch.randint(0, m, (500,), generator=gen,
                                      device="cuda")).values
    starts[:3] = torch.tensor([-7, m, m + 9], device="cuda")
    before = tiles.SLAB_GATHER32.launches
    for k in (1, 3, 256, 333, 2048):
        assert torch.equal(tiles.slab_gather(keys, starts, k, -1),
                           tiles.slab_gather_ref(keys, starts, k, -1))
    assert torch.equal(tiles.slab_gather(keys[1:], starts, 256, 7),
                       tiles.slab_gather_ref(keys[1:], starts, 256, 7))
    assert tiles.SLAB_GATHER32.launches == before + 6


@pytest.mark.parametrize("shape,offset", [((327_680, 10), 0),
                                          ((4_396_032, 10), 0),
                                          ((1001, 3), 1), ((1001, 3), 0),
                                          ((100_003,), 2), ((3,), 3)])
def test_copy_rows_kernel_exact(gen, shape, offset):
    """Kernel #7: bit-equal to its plain version into a new tensor, and into
    a view at each distance from a 16-byte boundary: the source's (a head, a
    bulk body, a tail) or another (one float at a time). One launch per
    copy, counted under the path its plan names; nothing outside the view
    is written. (1001, 3) is smaller than one bulk stage, (3,) than one
    16-byte vector."""
    from qed_splatter_tpu_torch.ops.copy_rows import COPY_ROWS, copy_plan, \
        copy_rows, copy_rows_ref

    n = int(np.prod(shape))
    x = torch.rand(n + offset, generator=gen, device="cuda")[offset:].view(
        shape)
    before = COPY_ROWS.launches
    y = copy_rows(x)
    torch.cuda.synchronize()
    assert COPY_ROWS.launches == before + 1
    assert torch.equal(y, copy_rows_ref(x)) and y.data_ptr() != x.data_ptr()
    for dst_off in range(4):
        buf = torch.full((n + 8,), float("nan"), device="cuda")
        out = buf[dst_off:dst_off + n].view(shape)
        plan = copy_plan(x.data_ptr(), out.data_ptr(), n)
        seen = dict(COPY_ROWS.variant_launches)
        assert copy_rows(x, out=out) is out
        torch.cuda.synchronize()
        assert torch.equal(out, x), (dst_off, plan)
        assert bool(buf[:dst_off].isnan().all())
        assert bool(buf[dst_off + n:].isnan().all())
        assert COPY_ROWS.variant_launches[plan.path] == seen.get(
            plan.path, 0) + 1
        assert (plan.path == "scalar") == (dst_off != offset or n < 4)


def test_microbench_times_a_graph_and_an_eager_loop(gen):
    from qed_splatter_tpu_torch.utils import microbench

    x = torch.rand((1 << 20,), generator=gen, device="cuda")
    graph = microbench.device_time_per_call(lambda a: a * 2, (x,), n=10)
    assert microbench.last_method == "graph" and 0 < graph < 1e-2
    eager = microbench.device_time_per_call(lambda a: a * 2, (x,), n=10,
                                            graph=False)
    assert microbench.last_method == "eager" and 0 < eager < 1e-2
    # a host sync cannot be captured: the eager timing, and it says so
    microbench.device_time_per_call(lambda a: float(a.sum()), (x,), n=3)
    assert microbench.last_method == "eager"


def _room_trainer(tmp_path, **kw):
    """A trainer on a small room (6 frames at 256x168) whose multi-step
    dispatch runs chunks of 5 steps."""
    from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
        TrainerConfig
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.testing import write_room_dataset

    if not (tmp_path / "room").exists():
        write_room_dataset(tmp_path / "room", num_frames=6, width=256,
                           height=168, sparse_ply=3000, workers=4)
    model = ModelConfig(num_downscales=0, warmup_length=5, refine_every=10,
                        init_capacity_headroom=3.0, max_per_tile=256,
                        adaptive_max_per_tile=False)
    args = dict(max_num_iterations=20, steps_per_eval_image=0,
                steps_per_eval_all_images=0, steps_per_save=5, log_every=5,
                output_dir=str(tmp_path / "out"),
                data=DataConfig(data=str(tmp_path / "room")), model=model,
                steps_per_dispatch=5)
    args.update(kw)
    return Trainer(TrainerConfig(**args))


def _eager_chunk(runner, state, perm, bgs):
    """The per-step loop on the runner's step, frames and backgrounds."""
    ds = runner.dataset.data
    gen = torch.Generator(device="cuda")
    losses = []
    for i, p in enumerate(perm):
        batch = {"c2w": ds["c2w"][p], "K": ds["K"][p],
                 "cam_idx": int(ds["cam_idx"][p]),
                 "rgb": ds["rgb_u8"][p].cpu().numpy().astype(np.float32)
                 / 255.0, "depth": ds["depth"][p]}
        inp = runner.step.inputs(batch, gen, state.step)
        if bgs is not None:
            inp.background = bgs[i]
        losses.append(float(runner.step.run(state, inp)["loss"]))
        state = dataclasses.replace(state, step=state.step + 1)
    return state, losses


def test_graph_chunk_matches_eager_chunk(gen, tmp_path):
    """One chunk as a CUDA graph (step 1 eager, 4 replays) against the
    per-step loop from one state, perm and backgrounds: per-step losses
    within 1e-4 relative (atomics), each replay read its camera, the Adam
    counts, step counter and visibility counts equal, every kernel counted
    once per step."""
    from qed_splatter_tpu_torch.engine.checkpoint import copy_state
    from qed_splatter_tpu_torch.engine.scan_runner import state_tensors
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    t = _room_trainer(tmp_path)
    runner, ds = t._get_scan_fn(1, 5, True, t.state.params.capacity)
    perm = t._next_perm(5)
    bgs = t._backgrounds(0, 5)
    for kern in (rp.COMPOSITE, rp.COMPOSITE_BWD, *tiles.BIN_KERNELS):
        kern.reset()
    a, metrics = runner(copy_state(t.state, "cuda"), perm, bgs)
    torch.cuda.synchronize()
    assert (runner.captures, runner.replays) == (1, 4)
    assert rp.COMPOSITE_BWD.launches == 5
    assert rp.COMPOSITE.launches == 5
    assert all(k.launches == 5 for k in tiles.BIN_KERNELS)
    rows = dict(zip(runner.names, metrics.cpu().numpy().T))
    np.testing.assert_array_equal(rows["cam_idx"],
                                  ds.data["cam_idx"].cpu().numpy()[perm])
    b, losses = _eager_chunk(runner, copy_state(t.state, "cuda"), perm, bgs)
    np.testing.assert_allclose(rows["loss"], losses, rtol=1e-4)
    assert int(runner.step_counter) == a.step == b.step == 5
    for g in a.opt_state:
        assert int(a.opt_state[g]["count"]) == int(b.opt_state[g]["count"])
    assert torch.equal(a.stats.vis_count, b.stats.vis_count)
    assert [x.data_ptr() for x in state_tensors(a)] == [
        x.data_ptr() for x in runner._bound]
    # a second chunk replays all five steps
    runner(a, t._next_perm(5), t._backgrounds(5, 5))
    assert (runner.captures, runner.replays) == (1, 9)


def test_graph_rebinds_after_refine_and_rollback(gen, tmp_path):
    """A refine and a rollback hand the runner new tensors: they are copied
    into the captured ones (no new capture), the replays read them."""
    from qed_splatter_tpu_torch.engine.checkpoint import copy_state
    from qed_splatter_tpu_torch.engine.scan_runner import state_tensors

    t = _room_trainer(tmp_path, on_divergence="rollback")
    t.train(max_steps=10, finalize=False)        # the refine at 10
    [runner] = t._runners.values()
    assert runner.captures == 1
    bound = [x.data_ptr() for x in runner._bound]
    assert [x.data_ptr() for x in state_tensors(t.state)] != bound
    # the refined state through the graph and through the per-step loop
    post = copy_state(t.state, "cuda")
    perm, bgs = [0, 1, 2, 3, 4], t._backgrounds(10, 5)
    a, metrics = runner(copy_state(post, "cuda"), perm, bgs)
    _, losses = _eager_chunk(runner, copy_state(post, "cuda"), perm, bgs)
    got = metrics[:, runner.names.index("loss")].cpu().numpy()
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    assert runner.captures == 1
    assert [x.data_ptr() for x in state_tensors(a)] == bound
    # a poisoned state diverges and rolls back to the step-10 checkpoint
    t.state.params.means.fill_(float("nan"))
    t.train(max_steps=20, finalize=False)
    assert t._rollbacks == 1 and t.state.step == 20
    assert bool(torch.isfinite(t.state.params.means).all())
    assert runner.captures == 1 and t._runners == {
        k: runner for k in t._runners}


def test_graph_outlives_the_ssim_band_cache(gen, tmp_path, monkeypatch):
    """Every SSIM band matrix the captured step reads stays alive after the
    cache drops it (the step holds them; a graph keeps none of its inputs
    alive), and the replays still equal the per-step loop."""
    import gc
    import weakref

    from qed_splatter_tpu_torch.engine.checkpoint import copy_state
    from qed_splatter_tpu_torch.ops import ssim as ssim_mod

    real, made = ssim_mod._band_matrix, []

    def recording(*args):
        band = real(*args)
        made.append(weakref.ref(band))
        return band

    monkeypatch.setattr(ssim_mod, "_band_matrix", recording)
    real.cache_clear()
    t = _room_trainer(tmp_path)
    runner, _ = t._get_scan_fn(1, 5, True, t.state.params.capacity)
    state0 = copy_state(t.state, "cuda")
    perm, bgs = t._next_perm(5), t._backgrounds(0, 5)
    runner(copy_state(state0, "cuda"), perm, bgs)        # the capture
    real.cache_clear()
    others = [real(n, 11, 1.5, torch.device("cuda")) for n in range(40, 50)]
    gc.collect()
    assert made and all(ref() is not None for ref in made)
    _, metrics = runner(copy_state(state0, "cuda"), perm, bgs)
    got = metrics[:, runner.names.index("loss")].cpu().numpy()
    _, losses = _eager_chunk(runner, copy_state(state0, "cuda"), perm, bgs)
    assert runner.captures == 1 and np.isfinite(got).all()
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    del others


def test_host_sync_in_the_body_makes_capture_raise(gen, tmp_path):
    """A host sync inside the captured body raises (the sync debug mode is
    "error" during the capture); nothing falls back to eager replays."""
    from qed_splatter_tpu_torch.engine.checkpoint import copy_state

    t = _room_trainer(tmp_path)
    runner, _ = t._get_scan_fn(1, 5, True, t.state.params.capacity)
    real, calls = runner.step.run, []

    def syncing(state, inp):
        calls.append(1)
        if len(calls) == 2:              # the capture, after the warm-up
            float(state.params.means.sum())
        return real(state, inp)

    runner.step.run = syncing
    try:
        with pytest.raises(RuntimeError):
            runner(copy_state(t.state, "cuda"), t._next_perm(5),
                   t._backgrounds(0, 5))
    finally:
        runner.step.run = real
    assert runner._graph is None and runner.replays == 0
    torch.cuda.synchronize()


def test_init_pc_and_render_on_the_card(gen, tmp_path):
    """``init-pc`` (backprojection and colorize on the card, the host core
    between) and ``render`` in each mode, through the CLI on CUDA: the
    cloud and colours match the CPU run's (99% of the points within 1e-4,
    their colours within one level), every render frame equals
    ``render(train=False)`` and launched the kernels."""
    import json

    from qed_splatter_tpu_torch import cli
    from qed_splatter_tpu_torch.data import png
    from qed_splatter_tpu_torch.data.ply import read_ply
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.models.splatfacto import render
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles
    from qed_splatter_tpu_torch.testing import (
        orbit_c2w_opengl,
        write_room_dataset,
    )

    root = tmp_path / "room"
    write_room_dataset(root, num_frames=6, width=256, height=168,
                       sparse_ply=3000, workers=4)
    clouds = {}
    for dev in ("cpu", "cuda"):
        assert cli.main(["init-pc", "--data", str(root), "--device", dev,
                         "--cache-dir", str(tmp_path / f"cache_{dev}"),
                         "--output-name", f"{dev}.ply",
                         "--no-update-transforms"]) == 0
        assert cli.main(["init-pc", "--data", str(root), "--device", dev,
                         "--colorize", "--input-name", f"{dev}.ply",
                         "--output-name", f"{dev}_c.ply",
                         "--no-update-transforms"]) == 0
        clouds[dev] = read_ply(root / f"{dev}_c.ply")
    # an ulp of the card's backprojection can move a point across a voxel
    # boundary: the clouds are matched point to point, not compared in order
    from scipy.spatial import cKDTree

    a, b = clouds["cuda"], clouds["cpu"]
    assert len(b) > 1000 and abs(len(a) - len(b)) <= 1e-3 * len(b)
    d, idx = cKDTree(b.positions).query(a.positions)
    same = d <= 1e-4
    assert same.mean() >= 0.99 and d.max() <= 0.05
    assert np.abs(a.colors[same].astype(int)
                  - b.colors[idx[same]].astype(int)).max() <= 1
    assert json.loads((root / "transforms.json").read_text())[
        "ply_file_path"] == "sparse_pc.ply"

    assert cli.main(["train", "--data", str(root), "--output-dir",
                     str(tmp_path / "out"), "--max-num-iterations", "20",
                     "--steps-per-eval-image", "0",
                     "--steps-per-eval-all-images", "0",
                     "--model.num-downscales", "0"]) == 0
    ck = tmp_path / "out" / "qed-splatter" / "ckpts"
    path = tmp_path / "cam.json"
    path.write_text(json.dumps({"render_width": 200, "render_height": 120,
                                "camera_path": [{
                                    "camera_to_world": orbit_c2w_opengl(
                                        1.5, a, 0.1).reshape(-1).tolist(),
                                    "fov": 70.0} for a in (0.0, 0.5)]}))
    state = ckpt.load_state(ck)
    cfg = ckpt.model_config_from_meta(ckpt.checkpoint_meta(ck))
    for name, extra in (
            ("orbit", ["--mode", "orbit", "--num-frames", "2", "--depth"]),
            ("eval", ["--mode", "eval", "--data", str(root)]),
            ("path", ["--camera-path", str(path)])):
        out = tmp_path / f"render_{name}"
        argv = ["--load-dir", str(ck), "--output-dir", str(out), *extra]
        rp.COMPOSITE.reset()
        tiles.BIN_EMIT.reset()
        assert cli.main(["render", *argv]) == 0
        ns = cli.render_parser().parse_args(argv)
        ns.mode = ns.mode or "path"
        cams = cli.render_cameras(ns, state.params)
        assert rp.COMPOSITE.launches >= len(cams)
        assert tiles.BIN_EMIT.launches >= len(cams)
        for i, (c2w, K, w, h) in enumerate(cams):
            want = cli.to_uint8(render(state.params, c2w, K, w, h, cfg,
                                       step=state.step, train=False).rgb)
            assert np.array_equal(png.read_png(out / f"frame_{i:05d}.png"),
                                  want)
