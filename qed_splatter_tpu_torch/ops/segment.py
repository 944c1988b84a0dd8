"""Per-tile gathers between gaussian rows and [T, C, K] slabs.

Port of the rank gather of ``qed_splatter_tpu.ops.segment``: gather
``params[order]`` once into depth-rank order, then address each tile's
slots by rank. Plain indexing. The backward reduces slab cotangent rows to
gaussian rows with ``index_add_`` (atomics on the GPU). The JAX package's
sort reductions, grouping permutation (``slab_perm``) and u16 big-slab split
are TPU scatter and gather workarounds with no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable


def ranked_gather_fwd(params: torch.Tensor,      # [N, C] gaussian-id order
                      order: torch.Tensor,       # [N] depth order (rank -> id)
                      tile_ranks: torch.Tensor,  # [T, K] ranks, -1 = empty
                      ) -> torch.Tensor:
    """Channel-major [T, C, K] slab; empty slots are 0."""
    by_rank = params[order]                            # [N, C] rank-space rows
    safe = torch.clamp(tile_ranks, min=0)
    ok = (tile_ranks >= 0)[:, None, :]
    slab = by_rank[safe].permute(0, 2, 1)              # [T, C, K]
    return torch.where(ok, slab, 0.0).contiguous()


class _RankedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, absgrad_seed, order, tile_ranks):
        ctx.save_for_backward(order, tile_ranks)
        ctx.shape = tuple(params.shape)
        ctx.with_abs = absgrad_seed is not None
        return ranked_gather_fwd(params, order, tile_ranks)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        order, tile_ranks = ctx.saved_tensors
        n, c = ctx.shape
        ranks = tile_ranks.reshape(-1)
        valid = ranks >= 0
        # Empty slots (rank -1) add exact zeros, spread over all rows: most
        # slots of a large-K slab are empty, and sending them all to one
        # spare row serializes their atomics on its address.
        spread = torch.arange(ranks.numel(), device=ranks.device) % max(n, 1)
        ids = torch.where(valid, order[torch.clamp(ranks, min=0)], spread)
        rows = torch.where(valid[:, None],
                           g.permute(0, 2, 1).reshape(-1, c), 0.0)
        d_params = rows.new_zeros((n, c)).index_add_(0, ids, rows)
        d_seed = None
        if ctx.with_abs:
            d_seed = rows.new_zeros((n, 2)).index_add_(
                0, ids, rows[:, :2].abs())
        return d_params, d_seed, None, None


def tile_gather_ranked(
    params: torch.Tensor,      # [N, C] (gaussian-id order)
    order: torch.Tensor,       # [N] depth order (rank -> id)
    tile_ranks: torch.Tensor,  # [T, K] depth ranks, -1 = empty slot
    absgrad_seed: Optional[torch.Tensor] = None,  # [N, 2] zeros
) -> torch.Tensor:
    """Differentiable rank-space gather, channel-major [T, C, K]; empty
    slots 0. The gradient of ``params`` sums each slot's cotangent row into
    its gaussian's row.

    ``absgrad_seed`` is splatfacto's absgrad side channel: its gradient is,
    per gaussian, the sum over the tiles holding it of |that slot's
    screen-mean cotangent| (channels 0:2), i.e. |the tile's summed mean
    gradient| summed over tiles, not |the sum over all tiles|."""
    return _RankedGather.apply(params, absgrad_seed, order, tile_ranks)
