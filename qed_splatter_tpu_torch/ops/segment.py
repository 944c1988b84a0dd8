"""Per-tile gathers between gaussian rows and [T, C, K] slabs.

Port of the forward rank gather of ``qed_splatter_tpu.ops.segment``
(``_ranked_gather_fwd_impl``): gather ``params[order]`` once into depth-rank
order, then address each tile's slots by rank. Plain indexing; the JAX
package's u16 big-slab split is a TPU gather workaround with no counterpart
here. The training VJPs (scatter-free reductions, absgrad) are not ported
yet.
"""

from __future__ import annotations

import torch


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
