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


@pytest.mark.parametrize("k", [1, 256, 333, 1024, 2048])
def test_slab_gather_rank_mode_exact(gen, k):
    """The gather fused with the rank mask: odd starts, starts at and past
    M, counts of 0, K and above K."""
    from qed_splatter_tpu_torch.ops import tiles

    m, t = 100_000, 500
    keys = torch.sort(torch.randint(0, 1 << 40, (m,), generator=gen,
                                    device="cuda")).values
    starts = torch.sort(torch.randint(0, m, (t,), generator=gen,
                                      device="cuda")).values
    starts[:5] = torch.tensor([-7, m, m + 9, m - 3, 1], device="cuda")
    counts = torch.randint(0, 2 * k + 2, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[5:9] = torch.tensor([0, 1, k, k + 1], device="cuda",
                               dtype=torch.int32)
    before = tiles.SLAB_GATHER.variant_launches.get("ranks", 0)
    got = tiles.slab_ranks(keys, starts, counts, k, 17)
    torch.cuda.synchronize()
    assert tiles.SLAB_GATHER.variant_launches["ranks"] == before + 1
    assert torch.equal(got, tiles.slab_ranks_ref(keys, starts, counts, k,
                                                 17))
    n = torch.minimum(counts.clamp(max=k).long(),
                      (m - starts.clamp(0, m)))
    slot = torch.arange(k, device="cuda")[None, :]
    assert bool((got[slot >= n[:, None]] == -1).all())
    assert bool((got[slot < n[:, None]] >= 0).all())


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
    for kern in (rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.SLAB_GATHER):
        kern.reset()
    trainer.train()
    assert rp.COMPOSITE_BWD.launches == 30
    assert rp.COMPOSITE.launches >= 30 and tiles.SLAB_GATHER.launches >= 30
    assert trainer.state.params.capacity >= 2 * cap
    rows = [json.loads(x) for x in open(trainer.run_dir / "metrics.jsonl")]
    assert all(np.isfinite(r["loss"]) for r in rows if r["split"] == "train")
    assert (trainer.run_dir / "splat.ply").exists()


@pytest.mark.parametrize("d,k,chunked", [(3, 128, False), (4, 256, False),
                                         (3, 333, False), (4, 2304, True)])
def test_mixed_kernels_match_plain(gen, d, k, chunked):
    """The mixed_precision (bf16 operand) forward and backward kernels
    against their plain versions: the forward within TOL with the block
    sums of its handoff equal, the backward, fed by that handoff, against
    autograd of the plain mixed forward; tile counts below K, exact zeros
    past them."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, ntx = 60, 10
    slabs = _slabs(gen, t, d, k, ntx)
    slabs[3] *= 0.5 if not chunked else 0.05
    counts = torch.randint(0, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[:3] = torch.tensor([0, 1, k], device="cuda", dtype=torch.int32)
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
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, 16,
                                      k_chunk=k_chunk, chunks_run=runs,
                                      tile_counts=counts, mixed=True)
    assert _bwd_rel_err(got, want) <= 1e-3
    past = torch.arange(k, device="cuda")[None, None, :] >= counts[
        :, None, None].long()
    assert all(not bool(torch.where(past, g, 0.0).any()) for g in got)


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
                                          ((1001, 3), 1)])
def test_copy_rows_kernel_exact(gen, shape, offset):
    """Kernel #7's port: bit-equal to its plain version, 16-byte accesses or
    (a misaligned view) one float at a time."""
    from qed_splatter_tpu_torch.ops.copy_rows import COPY_ROWS, copy_rows, \
        copy_rows_ref

    n = shape[0] * shape[1]
    x = torch.rand(n + offset, generator=gen, device="cuda")[offset:].view(
        shape)
    before = COPY_ROWS.launches
    y = copy_rows(x)
    torch.cuda.synchronize()
    assert COPY_ROWS.launches == before + 1
    assert torch.equal(y, copy_rows_ref(x)) and y.data_ptr() != x.data_ptr()


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
