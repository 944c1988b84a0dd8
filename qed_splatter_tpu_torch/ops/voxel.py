"""Voxel-grid downsampling, the plain PyTorch version (port of
``ops/voxel.py``).

Points in one voxel are averaged (positions and, when given, colors), as
Open3D's ``voxel_down_sample`` does. The voxel of a point is
``floor(p / voxel_size)``, the key of the JAX package's numpy version, so the
two agree exactly; the host core (``native.py``) keys by
``floor(p * (1 / voxel_size))`` in float32, which puts a point whose
``p * (1 / voxel_size)`` rounds up to an integer that ``p / voxel_size``
stays below into the next cell: a wall lying on a multiple of the voxel
size moves as a whole. :func:`cell_means` groups by either key. Cells come
out in sorted key order. The init-pointcloud tool runs the host core, as
the JAX package does; this version is what the tests and ``chip_smoke.py``
hold it against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def voxel_downsample(
    positions: torch.Tensor,                  # [N, 3]
    voxel_size: float,
    colors: Optional[torch.Tensor] = None,    # [N, 3] any dtype
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Average points (and colors) per voxel, on the points' device; sums in
    float64, results in the inputs' dtypes. Returns (positions, colors or
    None)."""
    if len(positions) == 0 or voxel_size <= 0:
        return positions, colors
    return cell_means(positions, torch.floor(positions / voxel_size), colors)


def cell_means(
    positions: torch.Tensor,                  # [N, 3]
    keys: torch.Tensor,                       # [N, 3] integral cell keys
    colors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Average points (and colors) by cell key, cells in sorted key order
    (``voxel_downsample`` with the keys given, e.g. the host core's
    ``floor(p * (1 / voxel))``)."""
    uniq, inverse = torch.unique(keys.to(torch.int64), dim=0,
                                 return_inverse=True)
    m = len(uniq)
    counts = torch.zeros(m, dtype=torch.float64, device=positions.device)
    counts.index_add_(0, inverse, torch.ones_like(inverse, dtype=torch.float64))

    def mean(x):
        acc = torch.zeros((m, 3), dtype=torch.float64, device=x.device)
        acc.index_add_(0, inverse, x.to(torch.float64))
        return acc / counts[:, None]

    out_colors = mean(colors).to(colors.dtype) if colors is not None else None
    return mean(positions).to(positions.dtype), out_colors
