"""Plain per-tile alpha compositor (port of ``ops/rasterize.py``).

Per-tile fixed-K front-to-back compositing over id lists from
:func:`qed_splatter_tpu_torch.ops.tiles.bin_gaussians`: gather each tile's K
gaussians, evaluate every alpha for the tile's 256 pixels in global pixel
coordinates, and reduce with an exclusive cumulative product of
transmittance. Tiles are processed in chunks under a memory budget. This is
the port's differentiable oracle for the CUDA compositor, and what
``render`` runs when ``ModelConfig.use_pallas`` is False.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Compositing constants shared with gsplat's kernels.
ALPHA_EPS = 1.0 / 255.0   # skip near-transparent contributions
ALPHA_MAX = 0.999         # clamp so transmittance never hits zero

# fp32 working set of one chunk's [Tc, P, K] intermediates
CHUNK_BYTES_CPU = 48 << 20
CHUNK_BYTES_CUDA = 512 << 20


class RasterizeResult(NamedTuple):
    render: torch.Tensor  # [H, W, D] composited channels (premultiplied)
    alpha: torch.Tensor   # [H, W, 1] accumulated opacity


def tile_chunk_size(t: int, p: int, k: int, device: torch.device) -> int:
    budget = CHUNK_BYTES_CUDA if device.type == "cuda" else CHUNK_BYTES_CPU
    return max(1, min(t, budget // max(p * k * 4, 1)))


def excl_transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product of (1 - alpha) along the last axis."""
    t_incl = torch.cumprod(1.0 - alpha, dim=-1)
    return torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]],
                     dim=-1)


def _composite_chunk(tile_idx, ids, means2d, conics, colors, opacities,
                     num_tiles_x, tile_size):
    tc, k = ids.shape
    safe = torch.clamp(ids, min=0)
    slot_ok = ids >= 0                           # [Tc, K]
    mg = means2d[safe]                           # [Tc, K, 2]
    cg = conics[safe]                            # [Tc, K, 3]
    colg = colors[safe]                          # [Tc, K, D]
    og = opacities[safe]                         # [Tc, K]

    # pixel centres of each tile, row-major (y, x): [Tc, P]
    dt = means2d.dtype
    ox = (tile_idx % num_tiles_x) * tile_size
    oy = (tile_idx // num_tiles_x) * tile_size
    local = torch.arange(tile_size, dtype=dt, device=means2d.device) + 0.5
    px = ox[:, None].to(dt) + local[None, :]     # [Tc, ts]
    py = oy[:, None].to(dt) + local[None, :]
    px = px[:, None, :].expand(tc, tile_size, tile_size).reshape(tc, -1)
    py = py[:, :, None].expand(tc, tile_size, tile_size).reshape(tc, -1)

    dx = mg[:, None, :, 0] - px[:, :, None]      # [Tc, P, K]
    dy = mg[:, None, :, 1] - py[:, :, None]
    sigma = (
        0.5 * (cg[:, None, :, 0] * dx * dx + cg[:, None, :, 2] * dy * dy)
        + cg[:, None, :, 1] * dx * dy
    )
    alpha = og[:, None, :] * torch.exp(-sigma)
    ok = slot_ok[:, None, :] & (sigma >= 0.0) & (alpha > ALPHA_EPS)
    alpha = torch.where(ok, torch.clamp(alpha, max=ALPHA_MAX), 0.0)
    w = alpha * excl_transmittance(alpha)        # [Tc, P, K]
    # weighted colour sum as a product-and-sum: full f32 whatever TF32 says
    out = (w[..., None] * colg[:, None, :, :]).sum(2)   # [Tc, P, D]
    acc = w.sum(-1)                                      # [Tc, P]
    return out, acc


def tiles_to_image(out: torch.Tensor, acc: torch.Tensor, num_tiles_x: int,
                   tile_size: int, width: int, height: int) -> RasterizeResult:
    """[T, P, D] / [T, P] tile-major pixels -> RasterizeResult [H, W, ...]."""
    t, _, d = out.shape
    num_tiles_y = t // num_tiles_x
    img = out.reshape(num_tiles_y, num_tiles_x, tile_size, tile_size, d)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        num_tiles_y * tile_size, num_tiles_x * tile_size, d
    )[:height, :width]
    a = acc.reshape(num_tiles_y, num_tiles_x, tile_size, tile_size)
    a = a.permute(0, 2, 1, 3).reshape(
        num_tiles_y * tile_size, num_tiles_x * tile_size
    )[:height, :width]
    return RasterizeResult(render=img, alpha=a[..., None])


def rasterize_tiles(
    tile_lists: torch.Tensor,   # [T, K] front-to-back ids, -1 pad
    means2d: torch.Tensor,      # [N, 2]
    conics: torch.Tensor,       # [N, 3]
    colors: torch.Tensor,       # [N, D] channels (RGB / RGB+depth)
    opacities: torch.Tensor,    # [N] in [0, 1]
    width: int,
    height: int,
    num_tiles_x: int,
    tile_size: int = 16,
) -> RasterizeResult:
    """Composite per-tile gaussian lists into an image (single camera)."""
    t, k = tile_lists.shape
    num_tiles_y = -(-t // num_tiles_x)
    if num_tiles_x * num_tiles_y != t:
        raise ValueError("tile grid mismatch")
    p = tile_size * tile_size
    tile_chunk = tile_chunk_size(t, p, k, means2d.device)
    tid = torch.arange(t, device=means2d.device)
    outs, accs = [], []
    for s in range(0, t, tile_chunk):
        o, a = _composite_chunk(tid[s:s + tile_chunk],
                                tile_lists[s:s + tile_chunk], means2d,
                                conics, colors, opacities, num_tiles_x,
                                tile_size)
        outs.append(o)
        accs.append(a)
    return tiles_to_image(torch.cat(outs), torch.cat(accs), num_tiles_x,
                          tile_size, width, height)
