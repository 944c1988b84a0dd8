"""Densification statistics (port of the stats part of
``engine/densify.py``).

Per-gaussian screen-space gradient statistics accumulated between refines:
splatfacto's ``xys_grad_norm``, ``vis_counts`` and ``max_2Dsize``. The
refine (dup/split/cull) and the opacity reset are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DensifyStats:
    grad_norm_sum: torch.Tensor   # [C] sum of absgrad 2-norms
    vis_count: torch.Tensor       # [C] steps visible (radius > 0)
    max_radii_frac: torch.Tensor  # [C] max radius / max(H, W)

    @classmethod
    def zeros(cls, capacity: int, device) -> "DensifyStats":
        return cls(*(torch.zeros((capacity,), dtype=torch.float32,
                                 device=device) for _ in range(3)))


def accumulate_stats(
    stats: DensifyStats,
    absgrad: torch.Tensor,   # [C, 2] summed |d loss / d means2d| this step
    radii: torch.Tensor,     # [C] int32
    max_hw: int,
) -> DensifyStats:
    vis = radii > 0
    g = torch.linalg.vector_norm(absgrad, dim=-1)
    return DensifyStats(
        grad_norm_sum=stats.grad_norm_sum + torch.where(vis, g, 0.0),
        vis_count=stats.vis_count + vis.to(torch.float32),
        max_radii_frac=torch.maximum(
            stats.max_radii_frac,
            torch.where(vis, radii.to(torch.float32) / float(max_hw), 0.0),
        ),
    )
