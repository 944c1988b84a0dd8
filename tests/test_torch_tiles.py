"""PyTorch port vs the JAX package: tile binning (exact integer equality)
and the window gather against the Pallas slab kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.ops.projection import project_gaussians as jproj
from qed_splatter_tpu.ops.tiles import bin_gaussians as jbin
from qed_splatter_tpu.ops.tiles import slab_gather_unaligned
from qed_splatter_tpu.testing import random_scene, simple_camera
from qed_splatter_tpu_torch.ops.tiles import bin_gaussians as tbin
from qed_splatter_tpu_torch.ops.tiles import slab_gather, slab_gather_ref

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
    with pytest.raises(TypeError):
        slab_gather(keys.to(torch.int32), starts, 4, -1)
    with pytest.raises(ValueError):
        slab_gather(keys, starts[None], 4, -1)
