"""Per-camera learned bilateral grid colour correction (port of
``models/bilateral_grid.py``).

Each training camera owns a [gh, gw, gd, 12] grid of affine colour
transforms. A rendered pixel samples its camera's grid trilinearly at
(y, x, guidance), the guidance being the pixel's luminance, and applies the
3x4 affine it gets to its RGB. Training regularizes the grids by total
variation over the grid axes.

The JAX package slices the grid as a sum over the gd levels of bilinear
resizes weighted by hat functions, a form for the TPU. That is trilinear
interpolation with half-pixel centres and clamped edges, which here is one
``F.grid_sample`` (``align_corners=False``, ``padding_mode="border"``, the
guidance axis at ``(2 z + 1) / gd - 1``) while the image is at least the
grid's size in both axes. When an image axis is shorter than the grid's,
``jax.image.resize`` low-pass filters that axis (a triangle kernel widened
by the reduction), which ``grid_sample`` does not; such images take
:func:`resize_weights`, the resize's own weight matrices, so both forms give
JAX's function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# identity 3x4 affine, row-major [3, 4] -> 12
_IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
_LUMA = (0.299, 0.587, 0.114)


def init_bilateral_grids(num_cameras: int, shape=(16, 16, 8),
                         device="cpu") -> torch.Tensor:
    """[num_cameras, gh, gw, gd, 12] identity grids."""
    gh, gw, gd = shape
    ident = torch.tensor(_IDENTITY, dtype=torch.float32, device=device)
    return ident.expand(num_cameras, gh, gw, gd, 12).contiguous()


def _guidance(rgb: torch.Tensor) -> torch.Tensor:
    """Luminance in [0, 1] ([H, W]), as products and sums (no TF32)."""
    g = rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1] + rgb[..., 2] * _LUMA[2]
    return torch.clamp(g, 0.0, 1.0)


def resize_weights(in_size: int, out_size: int, device="cpu") -> torch.Tensor:
    """[out_size, in_size] weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``scale_and_translate``'s triangle kernel, widened by
    the reduction when shrinking, renormalized over the input, zero where
    the sample lies outside it), in float32 as JAX computes them."""
    f32 = torch.float32
    scale = np.float32(out_size / in_size)
    inv_scale = float(np.float32(1.0) / scale)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = torch.abs(sample[None, :]
                  - torch.arange(in_size, dtype=f32, device=device)[:, None])
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.t().contiguous()


def _slice_resize(grid: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The JAX form: [H, W, 12] = sum over levels of hat(z - l) times the
    level's slab resized to the image."""
    gh, gw, gd, _ = grid.shape
    h, w = z.shape
    wy = resize_weights(gh, h, grid.device)
    wx = resize_weights(gw, w, grid.device)
    # separable resize as products and sums: [H, gw, gd, 12], then [H, W, ...]
    a = (wy[:, :, None, None, None] * grid[None]).sum(1)
    b = (wx[None, :, :, None, None] * a[:, None]).sum(2)
    levels = torch.arange(gd, dtype=z.dtype, device=z.device)
    hat = torch.clamp(1.0 - torch.abs(z[..., None] - levels), min=0.0)
    return (hat[..., None] * b).sum(2)


def _slice_sample(grid: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One trilinear ``grid_sample`` of the grid at (y, x, z): [H, W, 12]."""
    gh, gw, gd, _ = grid.shape
    h, w = z.shape
    dev = z.device
    xs = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    zn = (2.0 * z + 1.0) / gd - 1.0
    coords = torch.stack([xs[None, :].expand(h, w),
                          ys[:, None].expand(h, w), zn], dim=-1)
    vol = grid.permute(3, 2, 0, 1)[None]            # [1, 12, gd, gh, gw]
    out = F.grid_sample(vol, coords[None, None], mode="bilinear",
                        padding_mode="border", align_corners=False)
    return out[0, :, 0].permute(1, 2, 0)            # [H, W, 12]


def apply_bilateral_grid(grid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Slice one camera's grid with the rendered image and apply the affine.

    grid: [gh, gw, gd, 12]; rgb: [H, W, 3] in [0, 1]. Returns [H, W, 3].
    """
    gh, gw, gd, _ = grid.shape
    h, w, _ = rgb.shape
    z = _guidance(rgb) * (gd - 1)
    if h >= gh and w >= gw:
        coef = _slice_sample(grid, z)
    else:
        coef = _slice_resize(grid, z)
    m = coef.reshape(h, w, 3, 4)
    return ((m[..., :3] * rgb[..., None, :]).sum(-1) + m[..., 3])


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared difference along each grid axis (nerfstudio's
    tv_loss). grids: [..., gh, gw, gd, 12] -> scalar."""
    tv = 0.0
    for axis in (-4, -3, -2):
        d = torch.diff(grids, dim=axis)
        tv = tv + torch.mean(d * d)
    return tv
