"""Brute-force O(N*P) reference renderer (port of ``ops/naive.py``).

Composites every gaussian for every pixel in global depth order with the
alpha/transmittance formulas of :mod:`.rasterize`; no tile cap, so it is
ground truth for the tile path on small scenes.
"""

from __future__ import annotations

import torch

from qed_splatter_tpu_torch.ops.rasterize import (
    ALPHA_EPS,
    ALPHA_MAX,
    RasterizeResult,
    excl_transmittance,
)


def rasterize_naive(
    means2d: torch.Tensor,     # [N, 2]
    conics: torch.Tensor,      # [N, 3]
    colors: torch.Tensor,      # [N, D]
    opacities: torch.Tensor,   # [N]
    depths: torch.Tensor,      # [N]
    radii: torch.Tensor,       # [N] int32, 0 = culled
    width: int,
    height: int,
) -> RasterizeResult:
    order = torch.argsort(torch.where(radii > 0, depths, float("inf")),
                          stable=True)
    mg = means2d[order]
    cg = conics[order]
    colg = colors[order]
    og = torch.where(radii[order] > 0, opacities[order], 0.0)

    dt, dev = means2d.dtype, means2d.device
    ys = torch.arange(height, dtype=dt, device=dev) + 0.5
    xs = torch.arange(width, dtype=dt, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")   # [H, W]
    px = px.reshape(-1)
    py = py.reshape(-1)

    dx = mg[None, :, 0] - px[:, None]                # [P, N]
    dy = mg[None, :, 1] - py[:, None]
    sigma = (
        0.5 * (cg[None, :, 0] * dx * dx + cg[None, :, 2] * dy * dy)
        + cg[None, :, 1] * dx * dy
    )
    alpha = og[None, :] * torch.exp(-sigma)
    ok = (sigma >= 0.0) & (alpha > ALPHA_EPS)
    alpha = torch.where(ok, torch.clamp(alpha, max=ALPHA_MAX), 0.0)
    w = alpha * excl_transmittance(alpha)            # [P, N]
    img = (w[..., None] * colg[None]).sum(1)         # [P, D]
    acc = w.sum(-1)
    return RasterizeResult(
        render=img.reshape(height, width, -1),
        alpha=acc.reshape(height, width, 1),
    )
