"""Tile compositing through the hand-written CUDA kernel (forward).

Counterpart of ``qed_splatter_tpu.ops.rasterize_pallas`` (the module name is
kept so each function's counterpart is easy to find; nothing here is
Pallas). The JAX module's forward kernels ``_fwd_kernel`` and
``_fwd_kernel_skip`` are one CUDA kernel, ``csrc/composite.cu``, with the
same channel-major interface: slabs ``[T, C, K]`` in, ``[T, D, P]`` colour
and ``[T, 1, P]`` accumulated alpha out (P = 256 pixels of a 16x16 tile).

- :func:`composite_tiles` composites all K slots of every tile
  (``composite_tiles_pallas``).
- :func:`composite_tiles_chunked` adds the ``K_CHUNK`` depth chunks of
  ``composite_tiles_chunked``: a tile stops at a chunk boundary s when every
  pixel has 1 - acc < ``EARLY_STOP_EPS`` or ``tile_counts[t] <= s``.

Each wrapper launches the kernel on CUDA tensors and runs
:func:`composite_tiles_ref`, its plain PyTorch version, on CPU tensors. The
analytic backward (``_bwd_kernel``, ``_bwd_kernel_skip``) is not ported yet,
so nothing here is differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from qed_splatter_tpu_torch.cuda import CudaKernel, ptr
from qed_splatter_tpu_torch.ops.rasterize import (
    ALPHA_EPS,
    ALPHA_MAX,
    RasterizeResult,
    excl_transmittance,
    tile_chunk_size,
)
from qed_splatter_tpu_torch.ops.segment import ranked_gather_fwd

# Depth-chunk length of composite_tiles_chunked (the JAX package's VMEM bound;
# kept because the chunk boundaries are where tiles may stop).
K_CHUNK = 1024
# A tile whose every pixel has remaining transmittance below this skips the
# rest of its list (gsplat's per-pixel stop threshold).
EARLY_STOP_EPS = 1e-4

COMPOSITE = CudaKernel(
    "composite", "qed_composite_tiles",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 5 + [ctypes.c_float],
)


def _composite_local(means, conics, colors, opac, tile_idx, num_tiles_x,
                     tile_size):
    """Plain composite of one group of tiles over all its K slots, alpha in
    tile-local coordinates as the kernel evaluates it. [Tc, D, P], [Tc, 1, P]."""
    dev = means.device
    half = tile_size * 0.5
    ox = ((tile_idx % num_tiles_x) * tile_size).to(torch.float32)
    oy = ((tile_idx // num_tiles_x) * tile_size).to(torch.float32)
    pix = torch.arange(tile_size * tile_size, device=dev)
    pxl = (pix % tile_size).to(torch.float32) + (0.5 - half)   # [P]
    pyl = (pix // tile_size).to(torch.float32) + (0.5 - half)
    mxl = means[:, 0, :] - (ox + half)[:, None]                # [Tc, K]
    myl = means[:, 1, :] - (oy + half)[:, None]
    dx = mxl[:, None, :] - pxl[None, :, None]                  # [Tc, P, K]
    dy = myl[:, None, :] - pyl[None, :, None]
    ca = conics[:, None, 0, :]
    cb = conics[:, None, 1, :]
    cc = conics[:, None, 2, :]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    a_raw = opac[:, None, 0, :] * torch.exp(-sigma)
    mask = (sigma >= 0.0) & (a_raw > ALPHA_EPS)
    alpha = torch.where(mask, torch.clamp(a_raw, max=ALPHA_MAX), 0.0)
    w = alpha * excl_transmittance(alpha)                      # [Tc, P, K]
    out = (w[:, None, :, :] * colors[:, :, None, :]).sum(-1)   # [Tc, D, P]
    return out, w.sum(-1)[:, None, :]


def _composite_all(means, conics, colors, opac, num_tiles_x, tile_size):
    t, _, k = colors.shape
    p = tile_size * tile_size
    step = tile_chunk_size(t, p, k, colors.device)
    tid = torch.arange(t, device=colors.device)
    outs, accs = [], []
    for s in range(0, t, step):
        sl = slice(s, s + step)
        o, a = _composite_local(means[sl], conics[sl], colors[sl], opac[sl],
                                tid[sl], num_tiles_x, tile_size)
        outs.append(o)
        accs.append(a)
    return torch.cat(outs), torch.cat(accs)


def composite_tiles_ref(
    g_means: torch.Tensor,    # [T, 2, K]
    g_conics: torch.Tensor,   # [T, 3, K]
    g_colors: torch.Tensor,   # [T, D, K]
    g_opac: torch.Tensor,     # [T, 1, K] (0 for padded slots)
    num_tiles_x: int,
    tile_size: int = 16,
    tile_counts: Optional[torch.Tensor] = None,
    k_chunk: int = 0,
    chunks_run: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the compositing kernel: transmittance as an
    exclusive ``cumprod`` along K, tiles in groups under a memory budget.

    ``k_chunk > 0`` composes depth chunks of that length as
    ``composite_tiles_chunked`` does: out += (1 - acc) * out_chunk for the
    tiles where the chunk is live, zero elsewhere. ``chunks_run`` ([T]
    int32), when given, receives the number of chunks each tile composited."""
    t, _, k = g_colors.shape
    if k_chunk <= 0 or k <= k_chunk:
        out, acc = _composite_all(g_means, g_conics, g_colors, g_opac,
                                  num_tiles_x, tile_size)
        if chunks_run is not None:
            chunks_run.fill_(1 if k > 0 else 0)
        return out, acc
    if tile_counts is None:
        tile_counts = torch.full((t,), k, dtype=torch.int32,
                                 device=g_colors.device)
    out = acc = None
    runs = torch.zeros((t,), dtype=torch.int32, device=g_colors.device)
    for s in range(0, k, k_chunk):
        e = min(s + k_chunk, k)
        parts = (g_means[..., s:e], g_conics[..., s:e], g_colors[..., s:e],
                 g_opac[..., s:e])
        if out is None:
            out, acc = _composite_all(*parts, num_tiles_x, tile_size)
            runs += 1
            continue
        live = ((1.0 - acc[:, 0, :]).amax(-1) >= EARLY_STOP_EPS) & (
            tile_counts > s)
        o, a = _composite_all(*parts, num_tiles_x, tile_size)
        o = torch.where(live[:, None, None], o, 0.0)
        a = torch.where(live[:, None, None], a, 0.0)
        runs += live.to(torch.int32)
        trans = 1.0 - acc
        out = out + trans * o
        acc = acc + trans * a
    if chunks_run is not None:
        chunks_run.copy_(runs)
    return out, acc


def _check_slabs(g_means, g_conics, g_colors, g_opac, tile_counts,
                 chunks_run):
    if g_colors.dim() != 3:
        raise ValueError("colors must be [T, D, K]")
    t, d, k = g_colors.shape
    want = {"means": (g_means, 2), "conics": (g_conics, 3),
            "colors": (g_colors, d), "opac": (g_opac, 1)}
    dev = g_colors.device
    for name, (x, c) in want.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (t, c, k):
            raise ValueError(f"{name} must be [{t}, {c}, {k}], got "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, colors on {dev}")
    for name, x in (("tile_counts", tile_counts), ("chunks_run", chunks_run)):
        if x is None:
            continue
        if x.dtype != torch.int32 or tuple(x.shape) != (t,):
            raise ValueError(f"{name} must be int32 [{t}]")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, colors on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _composite(g_means, g_conics, g_colors, g_opac, num_tiles_x, tile_size,
               tile_counts, k_chunk, chunks_run):
    _check_slabs(g_means, g_conics, g_colors, g_opac, tile_counts,
                 chunks_run)
    t, d, k = g_colors.shape
    if g_colors.device.type == "cpu":
        return composite_tiles_ref(g_means, g_conics, g_colors, g_opac,
                                   num_tiles_x, tile_size, tile_counts,
                                   k_chunk, chunks_run)
    if tile_size != 16:
        raise ValueError("the CUDA compositor takes 16x16 tiles only")
    if not 1 <= d <= 4:
        raise ValueError(f"the CUDA compositor takes 1..4 channels, got {d}")
    ins = [x.contiguous() for x in (g_means, g_conics, g_colors, g_opac)]
    counts = tile_counts.contiguous() if tile_counts is not None else None
    p = tile_size * tile_size
    out = torch.empty((t, d, p), dtype=torch.float32, device=g_colors.device)
    acc = torch.empty((t, 1, p), dtype=torch.float32, device=g_colors.device)
    null = ctypes.c_void_p(None)
    COMPOSITE(
        *(ptr(x) for x in ins),
        ptr(counts) if counts is not None else null,
        ptr(out), ptr(acc),
        ptr(chunks_run) if chunks_run is not None else null,
        t, k, d, num_tiles_x, k_chunk, EARLY_STOP_EPS,
        variant="chunked" if 0 < k_chunk < k else "",
    )
    return out, acc


def composite_tiles(g_means, g_conics, g_colors, g_opac, num_tiles_x: int,
                    tile_size: int = 16):
    """Composite gathered per-tile gaussians -> ([T, D, P], [T, 1, P])."""
    return _composite(g_means, g_conics, g_colors, g_opac, num_tiles_x,
                      tile_size, None, 0, None)


def composite_tiles_chunked(g_means, g_conics, g_colors, g_opac,
                            num_tiles_x: int, tile_size: int = 16,
                            tile_counts: Optional[torch.Tensor] = None,
                            chunks_run: Optional[torch.Tensor] = None):
    """:func:`composite_tiles` over depth chunks of ``K_CHUNK`` with
    per-tile early termination at chunk boundaries, on saturation and, when
    ``tile_counts`` (uncapped per-tile intersections, int32 [T]) is given,
    on chunks that hold only padding. ``chunks_run`` (int32 [T]) receives
    the number of chunks each tile composited."""
    k = g_colors.shape[-1]
    k_chunk = K_CHUNK if k > K_CHUNK else 0
    return _composite(g_means, g_conics, g_colors, g_opac, num_tiles_x,
                      tile_size, tile_counts, k_chunk, chunks_run)


def rasterize_tiles_pallas(
    tile_ranks: torch.Tensor,    # [T, K] depth ranks from bin_gaussians, -1 pad
    order: torch.Tensor,         # [N] depth order (rank -> id)
    means2d: torch.Tensor,       # [N, 2]
    conics: torch.Tensor,        # [N, 3]
    colors: torch.Tensor,        # [N, D]
    opacities: torch.Tensor,     # [N]
    width: int,
    height: int,
    num_tiles_x: int,
    tile_size: int = 16,
    tile_counts: Optional[torch.Tensor] = None,
) -> RasterizeResult:
    """Forward render of binned gaussians through the compositing kernel,
    addressed by depth rank as the JAX eval path does: gather
    ``params[order]`` once, then each tile's slots by rank."""
    t, k = tile_ranks.shape
    d = colors.shape[-1]
    num_tiles_y = -(-t // num_tiles_x)
    if num_tiles_x * num_tiles_y != t:
        raise ValueError("tile grid mismatch")
    packed = torch.cat([means2d, conics, colors, opacities[:, None]],
                       dim=-1).to(torch.float32)      # [N, 6 + D]
    g = ranked_gather_fwd(packed, order, tile_ranks)
    out, acc = composite_tiles_chunked(
        g[:, 0:2].contiguous(), g[:, 2:5].contiguous(),
        g[:, 5:5 + d].contiguous(), g[:, 5 + d:6 + d].contiguous(),
        num_tiles_x, tile_size, tile_counts=tile_counts,
    )
    # [T, D, P] -> [H, W, D]
    img = out.reshape(num_tiles_y, num_tiles_x, d, tile_size, tile_size)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        num_tiles_y * tile_size, num_tiles_x * tile_size, d
    )[:height, :width]
    a = acc.reshape(num_tiles_y, num_tiles_x, tile_size, tile_size)
    a = a.permute(0, 2, 1, 3).reshape(
        num_tiles_y * tile_size, num_tiles_x * tile_size
    )[:height, :width]
    return RasterizeResult(render=img, alpha=a[..., None])
