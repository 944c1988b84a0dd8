"""The per-camera colour correction of the reference: the bilateral grid.

Each camera owns a [gh, gw, gd, 12] grid of 3x4 affine colour transforms
(Wang et al., "Bilateral Guided Radiance Field Processing", ACM TOG 43(4),
2024; nerfstudio's ``lib_bilagrid``, as qed-splatter applies it in its
``model.py``). A rendered pixel reads its camera's grid at (y, x, guidance),
the guidance being the pixel's luminance, and the affine it reads maps its
colour; training adds ten times the grids' total variation to the loss and
gives the grids an Adam group of their own (``bilateral_grid``).

Plain float32 PyTorch with no matrix product (so TF32 cannot enter), and
nothing of the program: the trilinear read is an explicit gather of the
eight corners around each pixel's grid coordinate, with half-pixel centres
and edges clamped to the grid, and weights of its own. An image smaller
than the grid in either axis is refused: no cell has one (the program reads
such an image through a resize instead, which this file does not follow).
"""

from __future__ import annotations

import torch

LUMA = (0.299, 0.587, 0.114)
TV_WEIGHT = 10.0


def guidance(rgb: torch.Tensor, depth_levels: int) -> torch.Tensor:
    """[H, W] grid coordinate along the guidance axis: the luminance,
    clamped to [0, 1], times ``depth_levels - 1``."""
    y = rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1] + rgb[..., 2] * LUMA[2]
    return torch.clamp(y, 0.0, 1.0) * (depth_levels - 1)


def _axis(coord: torch.Tensor, size: int):
    """Lower corner, upper corner and the upper corner's weight of each
    coordinate, clamped to [0, size - 1]."""
    c = torch.clamp(coord, 0.0, float(size - 1))
    lo = torch.floor(c)
    w = c - lo
    lo = lo.to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    return lo, hi, w


def slice_grid(grid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """[H, W, 12]: ``grid`` ([gh, gw, gd, 12]) read trilinearly at each
    pixel of ``rgb`` ([H, W, 3]): pixel (i, j) at grid row
    ``(i + 0.5) gh / H - 0.5``, column ``(j + 0.5) gw / W - 0.5`` and level
    :func:`guidance`."""
    gh, gw, gd, nc = grid.shape
    h, w, _ = rgb.shape
    if h < gh or w < gw:
        raise ValueError(f"an image of {w}x{h} is smaller than the grid's "
                         f"{gw}x{gh}: the reference reads no such image")
    dev = rgb.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (
        gh / h) - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (
        gw / w) - 0.5
    y0, y1, wy = _axis(ys, gh)
    x0, x1, wx = _axis(xs, gw)
    z0, z1, wz = _axis(guidance(rgb, gd), gd)
    y0, y1, wy = y0[:, None], y1[:, None], wy[:, None]
    x0, x1, wx = x0[None, :], x1[None, :], wx[None, :]
    flat = grid.reshape(gh * gw * gd, nc)
    out = torch.zeros((h, w, nc), dtype=grid.dtype, device=dev)
    for yi, fy in ((y0, 1.0 - wy), (y1, wy)):
        for xi, fx in ((x0, 1.0 - wx), (x1, wx)):
            for zi, fz in ((z0, 1.0 - wz), (z1, wz)):
                idx = (yi * gw + xi) * gd + zi
                out = out + (fy * fx * fz)[..., None] * flat[idx]
    return out


def apply_grid(grid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """The camera's affine applied to ``rgb`` ([H, W, 3] in [0, 1]), then
    clamped to [0, 1]."""
    h, w, _ = rgb.shape
    m = slice_grid(grid, rgb).reshape(h, w, 3, 4)
    out = (m[..., 0] * rgb[..., 0, None] + m[..., 1] * rgb[..., 1, None]
           + m[..., 2] * rgb[..., 2, None] + m[..., 3])
    return torch.clamp(out, 0.0, 1.0)


def tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Ten times the sum, over the three grid axes, of the mean squared
    difference of neighbours along the axis, over every camera's grid
    (``grids``: [num_cameras, gh, gw, gd, 12])."""
    tv = grids.new_zeros(())
    for axis in (1, 2, 3):
        n = grids.shape[axis]
        d = grids.narrow(axis, 1, n - 1) - grids.narrow(axis, 0, n - 1)
        tv = tv + torch.mean(d * d)
    return TV_WEIGHT * tv
