"""Tile binning: gaussians -> per-tile, depth-ordered, fixed-K lists.

Port of ``qed_splatter_tpu.ops.tiles.bin_gaussians`` on the forward (eval)
path. The binning decides which splats render, so its semantics are
reproduced exactly, integer for integer:

1. depth order from ONE sort of a quantized log-depth key whose low bits are
   the gaussian index (culled gaussians sort last);
2. hierarchical pair expansion: every gaussian gets
   ``small_tiles_per_gaussian`` (tile, gaussian) slots; the front-most "big"
   gaussians claim rows of an ``overflow_slots`` table carrying the rest of
   their bbox up to ``max_tiles_per_gaussian``; the others are truncated and
   counted; every cell passes the exact circle-tile test;
3. one sort of the packed key ``tile << rank_bits | depth_rank`` (unique, so
   the sort needs no stability), per-tile boundaries by ``searchsorted``;
4. the per-tile window gather and the front-most-K cap, one launch of the
   hand-written CUDA kernel ``csrc/slab_gather.cu`` in its rank mode on CUDA
   tensors (:func:`slab_ranks`).

Keys are int64: at 327,680 gaussians on 4,293 tiles the packed key uses
bit 31. The training-only gradient plan (``slab_perm``, ``slab_bounds``,
``inv_order``) is not part of this module yet.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from qed_splatter_tpu_torch.cuda import CudaKernel, ptr

SLAB_GATHER = CudaKernel(
    "slab_gather", "qed_slab_gather",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int],
)
# its gather mode on 4-byte keys (the microbenchmark's slab kernel)
SLAB_GATHER32 = CudaKernel(
    "slab_gather", "qed_slab_gather_i32",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int],
)


class TileBinning(NamedTuple):
    """Fixed-capacity per-tile gaussian lists for one camera."""

    tile_lists: Optional[torch.Tensor]  # [T, K] gaussian ids, -1 pad (or None)
    tile_counts: torch.Tensor   # [T] int32 intersections (uncapped)
    num_tiles_x: int
    num_tiles_y: int
    order: torch.Tensor         # [N] int64 depth order (valid first)
    num_truncated: torch.Tensor  # scalar: gaussians with bbox cells dropped
    tile_ranks: torch.Tensor    # [T, K] int64 depth ranks, -1 pad


def slab_gather_ref(sorted_keys: torch.Tensor, starts: torch.Tensor, k: int,
                    fill: int) -> torch.Tensor:
    """Plain version of :func:`slab_gather`: padded slicing."""
    m = sorted_keys.shape[0]
    padded = torch.cat([
        sorted_keys,
        torch.full((k,), fill, dtype=sorted_keys.dtype,
                   device=sorted_keys.device),
    ])
    idx = torch.clamp(starts, 0, m)[:, None] + torch.arange(
        k, device=starts.device)
    return padded[idx]


def slab_ranks_ref(sorted_keys: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, k: int,
                   rank_bits: int) -> torch.Tensor:
    """Plain version of :func:`slab_ranks`: the window gather, then the rank
    mask and the front-most-k cap (and -1 for a window element past M)."""
    m = sorted_keys.shape[0]
    slabs = slab_gather_ref(sorted_keys, starts, k, -1)
    k_idx = torch.arange(k, device=starts.device)[None, :]
    in_range = (k_idx < torch.clamp(counts[:, None], max=k)) & (
        torch.clamp(starts, 0, m)[:, None] + k_idx < m)
    return torch.where(in_range, slabs & ((1 << rank_bits) - 1),
                       torch.full_like(slabs, -1))


def _launch_slab(sorted_keys, starts, counts, k, fill, rank_bits):
    wide = sorted_keys.dtype == torch.int64
    if (not wide and (sorted_keys.dtype != torch.int32 or counts is not None)
            or starts.dtype != torch.int64):
        raise TypeError("the window gather takes int64 starts and int64 keys "
                        "(int32 keys in its gather mode)")
    if sorted_keys.dim() != 1 or starts.dim() != 1 or k <= 0:
        raise ValueError("the window gather takes 1-D keys, 1-D starts and "
                         "k > 0")
    if sorted_keys.device != starts.device:
        raise ValueError("keys and starts must be on one device")
    if counts is not None:
        if counts.dtype != torch.int32 or counts.shape != starts.shape:
            raise ValueError("counts must be int32, one per start")
        if counts.device != starts.device:
            raise ValueError("counts and starts must be on one device")
        if not 1 <= rank_bits <= 62:
            raise ValueError("rank_bits must be in 1..62")
    if sorted_keys.device.type == "cpu":
        if counts is None:
            return slab_gather_ref(sorted_keys, starts, k, fill)
        return slab_ranks_ref(sorted_keys, starts, counts, k, rank_bits)
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"unsupported device {sorted_keys.device}")
    keys = sorted_keys.contiguous()
    st = starts.contiguous()
    t = st.shape[0]
    out = torch.empty((t, k), dtype=keys.dtype, device=keys.device)
    if not wide:
        SLAB_GATHER32(ptr(keys), ptr(st), ptr(out), keys.shape[0], t, k,
                      fill)
    elif counts is None:
        SLAB_GATHER(ptr(keys), ptr(st), ctypes.c_void_p(None), ptr(out),
                    keys.shape[0], t, k, fill, 0)
    else:
        SLAB_GATHER(ptr(keys), ptr(st), ptr(counts.contiguous()), ptr(out),
                    keys.shape[0], t, k, -1, rank_bits, variant="ranks")
    return out


def slab_gather(sorted_keys: torch.Tensor, starts: torch.Tensor, k: int,
                fill: int) -> torch.Tensor:
    """[T, k] windows ``sorted_keys[s_t : s_t + k]`` with ``s_t`` clamped to
    [0, M]; elements past M read ``fill``. int64 starts; int64 keys, or
    int32 keys (4-byte elements: the port of the ``tools`` microbenchmark's
    slab kernel, its own launch count ``SLAB_GATHER32``).

    CUDA tensors launch ``csrc/slab_gather.cu``; CPU tensors take
    :func:`slab_gather_ref`."""
    return _launch_slab(sorted_keys, starts, None, k, fill, 0)


def slab_ranks(sorted_keys: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, k: int, rank_bits: int) -> torch.Tensor:
    """[T, k] depth ranks of each tile's front-most ``min(counts[t], k)``
    pairs, -1 past them: ``sorted_keys[s_t + j] & ((1 << rank_bits) - 1)``.
    The window gather and the rank mask in one pass. int64 keys and starts,
    int32 counts.

    CUDA tensors launch ``csrc/slab_gather.cu`` in its rank mode; CPU
    tensors take :func:`slab_ranks_ref`."""
    return _launch_slab(sorted_keys, starts, counts, k, 0, rank_bits)


def bin_gaussians(
    means2d: torch.Tensor,   # [N, 2]
    radii: torch.Tensor,     # [N] int32 (0 = culled)
    depths: torch.Tensor,    # [N]
    width: int,
    height: int,
    tile_size: int = 16,
    max_per_tile: int = 256,
    max_tiles_per_gaussian: int = 64,
    small_tiles_per_gaussian: int = 8,
    overflow_slots: int = 0,
    with_id_lists: bool = True,
    use_pallas: Optional[bool] = None,
) -> TileBinning:
    """Build per-tile front-to-back lists (single camera, forward path).

    ``overflow_slots=0`` auto-sizes to ``max(1024, N // 16)``.
    ``use_pallas=False`` asks for the plain window gather explicitly (the
    name mirrors the JAX argument); otherwise the gather dispatches on the
    tensors' device."""
    dev = means2d.device
    n = means2d.shape[0]
    tpg = max_tiles_per_gaussian
    tpg_small = min(small_tiles_per_gaussian, tpg)
    tpg_big = tpg - tpg_small
    if overflow_slots <= 0:
        overflow_slots = max(1024, n // 16)
    n_big = min(overflow_slots, n) if tpg_big > 0 else 0
    num_tiles_x = -(-width // tile_size)
    num_tiles_y = -(-height // tile_size)
    num_tiles = num_tiles_x * num_tiles_y
    i32 = torch.int32
    i64 = torch.int64

    culled = radii <= 0
    idx_bits = max((n - 1).bit_length(), 1)
    dq_bits = 32 - idx_bits
    if dq_bits >= 10:
        valid = ~culled
        inf = torch.tensor(float("inf"), dtype=depths.dtype, device=dev)
        lo = torch.log(torch.clamp(
            torch.where(valid, depths, inf).min(), min=1e-6))
        hi = torch.log(torch.clamp(
            torch.where(valid, depths, -inf).max(), min=1e-6))
        levels = (1 << dq_bits) - 2   # top bucket reserved for culled
        t = (torch.log(torch.clamp(depths, min=1e-6)) - lo) / torch.clamp(
            hi - lo, min=1e-9)
        q = torch.clamp((t * levels).to(i32), 0, levels - 1)
        q = torch.where(valid, q, levels + 1).to(i64)
        packed_key = (q << idx_bits) | torch.arange(n, device=dev)
        order = torch.sort(packed_key).values & ((1 << idx_bits) - 1)
    else:
        depth_key = torch.where(culled, float("inf"), depths)
        order = torch.argsort(depth_key, stable=True)

    packed_cols = torch.cat(
        [means2d, radii[:, None].to(means2d.dtype)], dim=-1)[order]
    mx = packed_cols[:, 0]
    my = packed_cols[:, 1]
    r = packed_cols[:, 2]
    alive = r > 0

    def tile_of(v, hi_tile):
        return torch.clamp(torch.floor(v / tile_size), 0, hi_tile).to(i32)

    x0 = tile_of(mx - r, num_tiles_x - 1)
    x1 = tile_of(mx + r, num_tiles_x - 1)
    y0 = tile_of(my - r, num_tiles_y - 1)
    y1 = tile_of(my + r, num_tiles_y - 1)
    zero = torch.zeros((), dtype=i32, device=dev)
    bw = torch.where(alive, x1 - x0 + 1, zero)           # bbox width in tiles
    area = bw * torch.where(alive, y1 - y0 + 1, zero)    # bbox cells

    def expand(rows, j0, tpg_rows):
        """Tile keys [tpg_rows, n_rows] for cells [j0, j0 + tpg_rows) of the
        depth positions ``rows`` (None = all): cell j covers tile
        (x0 + j % bw, y0 + j // bw); cells outside the bbox or whose tile
        is farther than the radius from the centre get key ``num_tiles``."""
        j = j0 + torch.arange(tpg_rows, dtype=i32, device=dev)[:, None]

        def sel(arr):
            return arr[None] if rows is None else arr[rows][None]

        mxr, myr, rr = sel(mx), sel(my), sel(r)
        bw_safe = torch.clamp(sel(bw), min=1)
        tx = sel(x0) + j % bw_safe
        ty = sel(y0) + j // bw_safe
        pair_valid = j < sel(area)
        cx = torch.minimum(torch.maximum(mxr, tx.to(mx.dtype) * tile_size),
                           (tx + 1).to(mx.dtype) * tile_size)
        cy = torch.minimum(torch.maximum(myr, ty.to(my.dtype) * tile_size),
                           (ty + 1).to(my.dtype) * tile_size)
        dx = mxr - cx
        dy = myr - cy
        pair_valid &= (dx * dx + dy * dy) <= rr * rr
        return torch.where(pair_valid, ty * num_tiles_x + tx,
                           torch.full_like(tx, num_tiles))

    all_rows = torch.arange(n, device=dev)
    keys_small = expand(None, 0, tpg_small)                 # [tpg_small, N]
    if n_big > 0:
        big = area > tpg_small
        # front-most big gaussians claim the overflow rows: one sort with
        # key (not-big, depth position) puts big rows first in depth order
        nb_bits = max((n - 1).bit_length(), 1)
        sel_key = ((~big).to(i64) << nb_bits) | all_rows
        big_sel = torch.sort(sel_key).values[:n_big] & ((1 << nb_bits) - 1)
        n_bigs_total = big.sum()
        sel_valid = torch.arange(n_big, device=dev) < n_bigs_total
        big_sel = torch.clamp(big_sel, max=n - 1)
        keys_big = expand(big_sel, tpg_small, tpg_big)      # [tpg_big, n_big]
        # tail rows past the last real big row get the sentinel key
        keys_big = torch.where(sel_valid[None, :], keys_big,
                               torch.full_like(keys_big, num_tiles))
        unselected = torch.clamp(n_bigs_total - n_big, min=0)
        over_budget = (sel_valid & (area[big_sel] > tpg)).sum()
        num_truncated = (unselected + over_budget).to(i32)
        keys = torch.cat([keys_small.reshape(-1), keys_big.reshape(-1)])
        rank_rows = torch.cat([
            all_rows[None].expand(tpg_small, n).reshape(-1),
            big_sel[None].expand(tpg_big, n_big).reshape(-1),
        ])
    else:
        num_truncated = (area > tpg_small).sum().to(i32)
        keys = keys_small.reshape(-1)
        rank_rows = all_rows[None].expand(tpg_small, n).reshape(-1)

    # key = tile << rank_bits | depth rank: unique keys, and the rank in the
    # low bits IS the within-tile depth order
    rank_bits = max((n - 1).bit_length(), 1)
    packed = (keys.to(i64) << rank_bits) | rank_rows
    packed_sorted = torch.sort(packed).values
    boundaries = torch.searchsorted(
        packed_sorted,
        torch.arange(num_tiles + 1, dtype=i64, device=dev) << rank_bits,
        side="left",
    )
    counts = (boundaries[1:] - boundaries[:-1]).to(i32)     # [T]
    starts = boundaries[:-1].contiguous()
    gather = slab_ranks_ref if use_pallas is False else slab_ranks
    ranks = gather(packed_sorted, starts, counts, max_per_tile, rank_bits)
    lists = None
    if with_id_lists:
        lists = torch.where(ranks >= 0, order[torch.clamp(ranks, min=0)],
                            torch.full_like(ranks, -1))
    return TileBinning(
        tile_lists=lists,
        tile_counts=counts,
        num_tiles_x=num_tiles_x,
        num_tiles_y=num_tiles_y,
        order=order,
        num_truncated=num_truncated,
        tile_ranks=ranks,
    )
