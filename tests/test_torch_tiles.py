"""PyTorch port vs the JAX package: tile binning (exact integer equality),
the window gather against the Pallas slab kernel in interpret mode, and the
gather fused with the rank mask against the JAX binning's own ranks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.ops.projection import project_gaussians as jproj
from qed_splatter_tpu.ops.tiles import bin_gaussians as jbin
from qed_splatter_tpu.ops.tiles import slab_gather_unaligned
from qed_splatter_tpu.testing import random_scene, simple_camera
from qed_splatter_tpu_torch.ops.tiles import bin_gaussians as tbin
from qed_splatter_tpu_torch.ops.tiles import (slab_gather, slab_gather_ref,
                                              slab_ranks, slab_ranks_ref)

W, H = 96, 64


def _projected(n, seed, scale_range):
    s = random_scene(n=n, seed=seed, scale_range=scale_range)
    vm, K = simple_camera(W, H, 60.0)
    r = jproj(*(jnp.asarray(s[k]) for k in ("means", "quats", "scales")),
              jnp.asarray(vm), jnp.asarray(K), W, H)
    return r.means2d[0], r.radii[0], r.depths[0]


# (n, seed, scale range, K, small_tiles_per_gaussian, overflow_slots):
# small splats; big splats overflowing the pair budget with an auto-sized
# and a tiny overflow table (truncation); a K cap that truncates tiles
CASES = [
    (2048, 0, (0.02, 0.12), 128, 8, 0),
    (1500, 1, (0.1, 0.6), 128, 8, 0),
    (1500, 1, (0.1, 0.6), 256, 2, 16),
    (300, 2, (0.02, 0.3), 64, 4, 0),
]


@pytest.mark.parametrize("n,seed,sr,k,small,ovf", CASES)
def test_binning_exactly_matches(n, seed, sr, k, small, ovf):
    m2d, radii, depths = _projected(n, seed, sr)
    j = jbin(m2d, radii, depths, W, H, max_per_tile=k,
             small_tiles_per_gaussian=small, overflow_slots=ovf,
             with_slab_plan=False)
    t = tbin(*(torch.tensor(np.asarray(x)) for x in (m2d, radii, depths)),
             W, H, max_per_tile=k, small_tiles_per_gaussian=small,
             overflow_slots=ovf)
    assert (t.num_tiles_x, t.num_tiles_y) == (j.num_tiles_x, j.num_tiles_y)
    for f in ("order", "tile_ranks", "tile_counts", "num_truncated",
              "tile_lists"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    if small < 8:
        assert int(t.num_truncated) > 0 or ovf == 0


def test_binning_culled_and_empty():
    m2d, radii, depths = _projected(256, 3, (0.02, 0.12))
    radii = np.asarray(radii).copy()
    radii[::3] = 0
    for rr in (radii, np.zeros_like(radii)):
        j = jbin(m2d, jnp.asarray(rr), depths, W, H, max_per_tile=128,
                 with_slab_plan=False)
        t = tbin(torch.tensor(np.asarray(m2d)), torch.tensor(rr),
                 torch.tensor(np.asarray(depths)), W, H, max_per_tile=128)
        for f in ("order", "tile_ranks", "tile_counts", "num_truncated"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))


@pytest.mark.parametrize("k", [128, 256, 1024])
def test_window_gather_matches_pallas(k):
    rng = np.random.default_rng(k)
    m, t = 20_000, 97
    keys = np.sort(rng.integers(0, 2**32, m, dtype=np.uint64)).astype(
        np.uint32)
    starts = np.sort(rng.integers(0, m, t)).astype(np.int32)
    starts[:6] = [0, 1, 127, 1024, m - 10, m]     # edge offsets, past M
    want = np.asarray(slab_gather_unaligned(
        jnp.asarray(keys), jnp.asarray(starts), k, fill=-1, interpret=True))
    got = slab_gather(torch.tensor(keys.astype(np.int64)),
                      torch.tensor(starts.astype(np.int64)), k,
                      fill=0xFFFFFFFF)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_window_gather_clamps_and_checks():
    keys = torch.arange(50, dtype=torch.int64)
    starts = torch.tensor([-5, 0, 49, 50, 70], dtype=torch.int64)
    got = slab_gather(keys, starts, 4, -1)
    assert got.tolist() == [[0, 1, 2, 3], [0, 1, 2, 3], [49, -1, -1, -1],
                            [-1] * 4, [-1] * 4]
    assert torch.equal(got, slab_gather_ref(keys, starts, 4, -1))
    # 4-byte keys are the microbenchmark's form (kernel #6); other key
    # types are refused
    assert torch.equal(slab_gather(keys.to(torch.int32), starts, 4, -1),
                       got.to(torch.int32))
    with pytest.raises(TypeError):
        slab_gather(keys.to(torch.float32), starts, 4, -1)
    with pytest.raises(TypeError):
        slab_gather(keys.to(torch.int16), starts, 4, -1)
    with pytest.raises(ValueError):
        slab_gather(keys, starts[None], 4, -1)


@pytest.mark.parametrize("n,seed,sr,k,small,ovf", CASES)
def test_fused_rank_gather_matches_binning(n, seed, sr, k, small, ovf):
    """``slab_ranks`` on keys packed from JAX's own per-tile ranks gives
    JAX's ``tile_ranks`` back exactly, front-most-K cap included, and
    ``bin_gaussians`` takes it on both of its gather settings."""
    m2d, radii, depths = _projected(n, seed, sr)
    j = jbin(m2d, radii, depths, W, H, max_per_tile=4096,
             small_tiles_per_gaussian=small, overflow_slots=ovf,
             with_slab_plan=False)
    full = np.asarray(j.tile_ranks)               # uncapped lists
    counts = np.asarray(j.tile_counts)
    assert counts.max() <= full.shape[1]
    rank_bits = max((n - 1).bit_length(), 1)
    rows = [(t << rank_bits) | full[t, :c].astype(np.int64)
            for t, c in enumerate(counts)]
    keys = torch.tensor(np.concatenate(rows + [np.array(
        [len(counts) << rank_bits] * 3, np.int64)]))   # sentinel tile keys
    starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)[:-1]])
                          .astype(np.int64))
    got = slab_ranks(keys, starts, torch.tensor(counts), k, rank_bits)
    want = jbin(m2d, radii, depths, W, H, max_per_tile=k,
                small_tiles_per_gaussian=small, overflow_slots=ovf,
                with_slab_plan=False).tile_ranks
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args = [torch.tensor(np.asarray(x)) for x in (m2d, radii, depths)]
    for use in (None, False):
        t = tbin(*args, W, H, max_per_tile=k, small_tiles_per_gaussian=small,
                 overflow_slots=ovf, use_pallas=use)
        np.testing.assert_array_equal(t.tile_ranks.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 4, 7])
def test_fused_rank_gather_edges(k):
    """start = M, start past M, negative start, count = 0, count > K, and a
    window that runs past M inside its count."""
    m = 50
    keys = (torch.arange(m, dtype=torch.int64) << 8) | (
        torch.arange(m, dtype=torch.int64) % 200)
    starts = torch.tensor([0, m, m + 20, -4, 10, m - 2, 30], dtype=torch.int64)
    counts = torch.tensor([3, 5, 1, 2, 0, 9, 100], dtype=torch.int32)
    got = slab_ranks(keys, starts, counts, k, 8)
    assert torch.equal(got, slab_ranks_ref(keys, starts, counts, k, 8))
    s0 = starts.clamp(0, m)
    for t in range(len(starts)):
        n = min(int(counts[t]), k, m - int(s0[t]))
        assert got[t, :n].tolist() == [(int(s0[t]) + i) % 200
                                       for i in range(n)]
        assert (got[t, n:] == -1).all()
    with pytest.raises(ValueError):
        slab_ranks(keys, starts, counts.long(), k, 8)
    with pytest.raises(ValueError):
        slab_ranks(keys, starts, counts[:3], k, 8)
    with pytest.raises(ValueError):
        slab_ranks(keys, starts, counts, k, 0)
