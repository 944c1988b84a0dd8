"""Tile compositing through the hand-written CUDA kernels, forward and
backward.

Counterpart of ``qed_splatter_tpu.ops.rasterize_pallas`` (the module name is
kept so each function's counterpart is easy to find; nothing here is
Pallas). The channel-major interface is the JAX module's: slabs
``[T, C, K]`` in, ``[T, D, P]`` colour and ``[T, 1, P]`` accumulated alpha
out (P = 256 pixels of a 16x16 tile).

- ``csrc/composite.cu`` is the forward (``_fwd_kernel``, ``_fwd_kernel_skip``).
- ``csrc/composite_bwd.cu`` is the analytic backward (``_bwd_kernel``,
  ``_bwd_kernel_skip``): a front-to-back sweep for T and a back-to-front
  sweep for what lies behind each slot. It replays exactly the chunks the
  forward composited (the forward's per-tile ``chunks_run``) and stops at
  the tile's count.

:func:`composite_tiles` composites all K slots of every tile;
:func:`composite_tiles_chunked` adds the ``K_CHUNK`` depth chunks: a tile
stops at a chunk boundary s when every pixel has 1 - acc < ``EARLY_STOP_EPS``
or ``tile_counts[t] <= s``. Both are differentiable through one
``torch.autograd.Function``. On CUDA tensors the kernels run; on CPU tensors
their plain versions, :func:`composite_tiles_ref` and
:func:`composite_tiles_bwd_sweeps_ref` (the backward kernel's algorithm in
plain PyTorch). :func:`composite_tiles_bwd_ref`, the autograd VJP of the
plain forward, is the oracle both are held against.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from qed_splatter_tpu_torch.cuda import CudaKernel, ptr
from qed_splatter_tpu_torch.ops.rasterize import (
    ALPHA_EPS,
    ALPHA_MAX,
    RasterizeResult,
    excl_transmittance,
    tile_chunk_size,
)
from qed_splatter_tpu_torch.ops.segment import tile_gather_ranked

# Depth-chunk length of composite_tiles_chunked (the JAX package's VMEM bound;
# kept because the chunk boundaries are where tiles may stop).
K_CHUNK = 1024
# A tile whose every pixel has remaining transmittance below this skips the
# rest of its list (gsplat's per-pixel stop threshold).
EARLY_STOP_EPS = 1e-4
# The plain backward keeps the autograd graph of a tile group alive: about
# 20 [Tc, P, K] f32 intermediates, so its groups are this much smaller than
# the forward's.
BWD_GROUP_DIVISOR = 24
# The backward stops carrying T below this (float32's normal range ends at
# 1.2e-38); gradients behind are zero.
TRANS_MIN = 1e-30

COMPOSITE = CudaKernel(
    "composite", "qed_composite_tiles",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 5 + [ctypes.c_float],
)
COMPOSITE_BWD = CudaKernel(
    "composite_bwd", "qed_composite_tiles_bwd",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5,
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


def _composite_group(means, conics, colors, opac, tile_idx, num_tiles_x,
                     tile_size, k_chunk, live):
    """One group of tiles over depth chunks of ``k_chunk`` (all K when 0),
    composed as ``out_A + (1 - acc_A) out_B``. ``live(s, acc)`` -> [Tc] bool
    says which tiles composite the chunk starting at s; a tile that does not
    sees that chunk as zeros (no contribution, exact zero gradients).
    Returns (out, acc, chunks run [Tc] int32)."""
    tc, _, k = colors.shape
    runs = torch.full((tc,), 1 if k > 0 else 0, dtype=torch.int32,
                      device=colors.device)
    if k_chunk <= 0 or k <= k_chunk:
        out, acc = _composite_local(means, conics, colors, opac, tile_idx,
                                    num_tiles_x, tile_size)
        return out, acc, runs
    out = acc = None
    for s in range(0, k, k_chunk):
        parts = [x[..., s:s + k_chunk] for x in (means, conics, colors, opac)]
        if out is None:
            out, acc = _composite_local(*parts, tile_idx, num_tiles_x,
                                        tile_size)
            continue
        on = live(s, acc.detach())
        runs = runs + on.to(torch.int32)
        parts = [torch.where(on[:, None, None], x, 0.0) for x in parts]
        o, a = _composite_local(*parts, tile_idx, num_tiles_x, tile_size)
        trans = 1.0 - acc
        out = out + trans * o
        acc = acc + trans * a
    return out, acc, runs


def _forward_live(counts):
    """The forward's chunk predicate (``_fwd_kernel_skip``)."""
    def live(s, acc):
        return ((1.0 - acc[:, 0, :]).amax(-1) >= EARLY_STOP_EPS) & (
            counts > s)
    return live


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
    dev = g_colors.device
    if tile_counts is None:
        tile_counts = torch.full((t,), k, dtype=torch.int32, device=dev)
    chunked = 0 < k_chunk < k
    p = tile_size * tile_size
    step = tile_chunk_size(t, p, k_chunk if chunked else k, dev)
    tid = torch.arange(t, device=dev)
    outs, accs, runs = [], [], []
    for s in range(0, t, step):
        sl = slice(s, s + step)
        o, a, r = _composite_group(
            g_means[sl], g_conics[sl], g_colors[sl], g_opac[sl], tid[sl],
            num_tiles_x, tile_size, k_chunk if chunked else 0,
            _forward_live(tile_counts[sl]))
        outs.append(o)
        accs.append(a)
        runs.append(r)
    if chunks_run is not None:
        chunks_run.copy_(torch.cat(runs))
    return torch.cat(outs), torch.cat(accs)


def composite_tiles_bwd_ref(
    g_means, g_conics, g_colors, g_opac,   # the forward's slabs
    gout: torch.Tensor,                    # [T, D, P] cotangent of out
    gacc: torch.Tensor,                    # [T, 1, P] cotangent of acc
    num_tiles_x: int,
    tile_size: int = 16,
    k_chunk: int = 0,
    chunks_run: Optional[torch.Tensor] = None,
):
    """Plain version of the backward kernel: the VJP of
    :func:`composite_tiles_ref` by ``torch.autograd.grad``, one group of
    tiles at a time under ``tile_chunk_size / BWD_GROUP_DIVISOR`` (never one
    graph over the whole frame). When chunked, ``chunks_run`` (the
    forward's, [T] int32) is required and replayed exactly per tile, as the
    kernel does. Returns (dmeans, dconics, dcolors, dopac) like the slabs."""
    t, _, k = g_colors.shape
    dev = g_colors.device
    slabs = (g_means, g_conics, g_colors, g_opac)
    grads = [torch.zeros_like(x) for x in slabs]
    chunked = 0 < k_chunk < k
    if chunked and chunks_run is None:
        raise ValueError("a chunked backward needs the forward's chunks_run")
    p = tile_size * tile_size
    step = max(1, tile_chunk_size(t, p, k_chunk if chunked else k, dev)
               // BWD_GROUP_DIVISOR)
    tid = torch.arange(t, device=dev)
    for s in range(0, t, step):
        sl = slice(s, s + step)
        runs = chunks_run[sl] if chunked else None

        def live(c0, acc, runs=runs):
            return runs > c0 // k_chunk

        with torch.enable_grad():
            leaves = [x[sl].detach().requires_grad_(True) for x in slabs]
            o, a, _ = _composite_group(*leaves, tid[sl], num_tiles_x,
                                       tile_size, k_chunk if chunked else 0,
                                       live)
            part = torch.autograd.grad((o, a), leaves, (gout[sl], gacc[sl]),
                                       allow_unused=True)
        for g, d in zip(grads, part):
            if d is not None:
                g[sl] = d
    return tuple(grads)


def slots_run(t, k, k_chunk, chunks_run, tile_counts, device):
    """[T] int64: how many leading slots of each tile the backward runs,
    ``min(chunks_run * k_chunk, tile_counts, K)`` over what is given."""
    n = torch.full((t,), k, dtype=torch.int64, device=device)
    if chunks_run is not None:
        n = torch.minimum(n, chunks_run.long() * (k_chunk if 0 < k_chunk < k
                                                  else k))
    if tile_counts is not None:
        n = torch.minimum(n, tile_counts.long().clamp(min=0))
    return n


def composite_tiles_bwd_sweeps_ref(
    g_means, g_conics, g_colors, g_opac,   # the forward's slabs
    gout: torch.Tensor,                    # [T, D, P] cotangent of out
    gacc: torch.Tensor,                    # [T, 1, P] cotangent of acc
    num_tiles_x: int,
    tile_size: int = 16,
    k_chunk: int = 0,
    chunks_run: Optional[torch.Tensor] = None,
    tile_counts: Optional[torch.Tensor] = None,
    total: Optional[torch.Tensor] = None,
):
    """Plain version of the backward kernel's algorithm, one group of tiles
    at a time: the direct chain rule with

      dalpha_k = T_k (dw_k - Q_k),

    T from a front-to-back sweep (zero where it falls below ``TRANS_MIN``)
    and Q_k, what lies behind slot k composited on its own, from a
    back-to-front sweep: Q_{k-1} = alpha_k dw_k + (1 - alpha_k) Q_k. Only
    the slots :func:`slots_run` counts are replayed; the rest get exact
    zeros. Returns (dmeans, dconics, dcolors, dopac).

    ``total`` ([T, P], S = sum_c gout_c out_c + gacc acc of the forward's
    outputs) selects the one-sweep form instead, which the kernel does not
    use: dalpha_k = T_k dw_k - (S - prefix_k) / (1 - alpha_k), with no
    back-to-front sweep. It is here so that its error can be measured."""
    t, d, k = g_colors.shape
    dev = g_colors.device
    dt = g_colors.dtype
    chunked = 0 < k_chunk < k
    if chunked and chunks_run is None:
        raise ValueError("a chunked backward needs the forward's chunks_run")
    n_run = slots_run(t, k, k_chunk, chunks_run if chunked else None,
                      tile_counts, dev)
    grads = [torch.zeros_like(x) for x in (g_means, g_conics, g_colors,
                                           g_opac)]
    p = tile_size * tile_size
    step = max(1, tile_chunk_size(t, p, k, dev) // BWD_GROUP_DIVISOR)
    half = tile_size * 0.5
    pix = torch.arange(p, device=dev)
    pxl = (pix % tile_size).to(dt) + (0.5 - half)              # [P]
    pyl = (pix // tile_size).to(dt) + (0.5 - half)
    slot = torch.arange(k, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for s in range(0, t, step):
        sl = slice(s, s + step)
        tid = torch.arange(s, min(s + step, t), device=dev)
        ox = ((tid % num_tiles_x) * tile_size).to(dt)
        oy = ((tid // num_tiles_x) * tile_size).to(dt)
        run = slot[None, :] < n_run[sl, None]                  # [Tc, K]
        n_max = int(n_run[sl].max()) if tid.numel() else 0
        dx = (g_means[sl, 0] - (ox + half)[:, None])[:, None, :] \
            - pxl[None, :, None]                               # [Tc, P, K]
        dy = (g_means[sl, 1] - (oy + half)[:, None])[:, None, :] \
            - pyl[None, :, None]
        ca = g_conics[sl, None, 0, :]
        cb = g_conics[sl, None, 1, :]
        cc = g_conics[sl, None, 2, :]
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        e = torch.exp(-sigma)
        a_raw = g_opac[sl, None, 0, :] * e
        keep = (sigma >= 0.0) & (a_raw > ALPHA_EPS) & run[:, None, :]
        alpha = torch.where(keep, torch.clamp(a_raw, max=ALPHA_MAX), 0.0)
        trans = excl_transmittance(alpha)                      # sweep 1
        trans = torch.where(trans >= TRANS_MIN, trans, zero)
        go = gout[sl]                                          # [Tc, D, P]
        dw = gacc[sl, 0, :, None] + torch.einsum(
            "tdp,tdk->tpk", go, g_colors[sl])
        w = alpha * trans
        if total is None:
            dw_k = dw.permute(2, 0, 1).contiguous()            # [K, Tc, P]
            alpha_k = alpha.permute(2, 0, 1).contiguous()
            diff_k = torch.zeros_like(dw_k)                    # dw_k - Q_k
            behind = torch.zeros_like(dw_k[0])                 # Q, [Tc, P]
            for j in range(n_max - 1, -1, -1):                 # sweep 2
                diff_k[j] = dw_k[j] - behind
                behind = behind + alpha_k[j] * diff_k[j]
            dalpha = trans * diff_k.permute(1, 2, 0)
        else:
            rest = total[sl, :, None] - torch.cumsum(w * dw, dim=-1)
            dalpha = trans * dw - rest / (1.0 - alpha)
        da = torch.where(keep & (a_raw <= ALPHA_MAX), dalpha, zero)
        dsig = -a_raw * da
        r0 = (dsig * dx).sum(1)                                # [Tc, K]
        r1 = (dsig * dy).sum(1)
        cak, cbk, cck = ca[:, 0], cb[:, 0], cc[:, 0]

        def put(x):                       # exact zeros past the replayed slots
            return torch.where(run, x, zero)

        grads[0][sl, 0] = put(cak * r0 + cbk * r1)
        grads[0][sl, 1] = put(cck * r1 + cbk * r0)
        grads[1][sl, 0] = put(0.5 * (dsig * dx * dx).sum(1))
        grads[1][sl, 1] = put((dsig * dx * dy).sum(1))
        grads[1][sl, 2] = put(0.5 * (dsig * dy * dy).sum(1))
        grads[3][sl, 0] = put((da * e).sum(1))
        grads[2][sl] = torch.where(run[:, None, :],
                                   torch.einsum("tdp,tpk->tdk", go, w), zero)
    return tuple(grads)


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


def _check_cuda_shapes(tile_size, d):
    if tile_size != 16:
        raise ValueError("the CUDA compositor takes 16x16 tiles only")
    if not 1 <= d <= 4:
        raise ValueError(f"the CUDA compositor takes 1..4 channels, got {d}")


def _composite(g_means, g_conics, g_colors, g_opac, num_tiles_x, tile_size,
               tile_counts, k_chunk, chunks_run):
    """Forward: the kernel on CUDA tensors, the plain version on CPU ones.
    ``chunks_run`` ([T] int32) receives the chunks each tile composited."""
    _check_slabs(g_means, g_conics, g_colors, g_opac, tile_counts,
                 chunks_run)
    t, d, k = g_colors.shape
    if g_colors.device.type == "cpu":
        return composite_tiles_ref(g_means, g_conics, g_colors, g_opac,
                                   num_tiles_x, tile_size, tile_counts,
                                   k_chunk, chunks_run)
    _check_cuda_shapes(tile_size, d)
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


def composite_tiles_bwd(g_means, g_conics, g_colors, g_opac, gout, gacc,
                        num_tiles_x: int, tile_size: int, k_chunk: int,
                        chunks_run: torch.Tensor,
                        tile_counts: Optional[torch.Tensor] = None):
    """Backward of the compositor, from the forward's slabs and the chunks
    it ran (``chunks_run`` [T] int32). With ``tile_counts`` (int32 [T]) a
    tile stops at its count: slots at or past it are padding (opacity 0).
    ``csrc/composite_bwd.cu`` on CUDA tensors,
    :func:`composite_tiles_bwd_sweeps_ref` on CPU tensors. Returns
    (dmeans, dconics, dcolors, dopac), exact zeros past each tile's
    replayed slots."""
    _check_slabs(g_means, g_conics, g_colors, g_opac, tile_counts,
                 chunks_run)
    t, d, k = g_colors.shape
    p = tile_size * tile_size
    for name, x, c in (("gout", gout, d), ("gacc", gacc, 1)):
        if x.dtype != torch.float32 or tuple(x.shape) != (t, c, p):
            raise ValueError(f"{name} must be float32 [{t}, {c}, {p}]")
        if x.device != g_colors.device:
            raise ValueError(f"{name} is on {x.device}, colors on "
                             f"{g_colors.device}")
    if g_colors.device.type == "cpu":
        return composite_tiles_bwd_sweeps_ref(
            g_means, g_conics, g_colors, g_opac, gout, gacc, num_tiles_x,
            tile_size, k_chunk, chunks_run, tile_counts)
    _check_cuda_shapes(tile_size, d)
    ins = [x.contiguous() for x in (g_means, g_conics, g_colors, g_opac,
                                    gout, gacc, chunks_run)]
    counts = (ptr(tile_counts.contiguous()) if tile_counts is not None
              else ctypes.c_void_p(None))
    grads = [torch.empty_like(x) for x in ins[:4]]
    COMPOSITE_BWD(
        *(ptr(x) for x in ins), counts, *(ptr(x) for x in grads),
        t, k, d, num_tiles_x, k_chunk,
        variant="chunked" if 0 < k_chunk < k else "",
    )
    return tuple(grads)


class _Composite(torch.autograd.Function):
    """The compositor with the analytic backward. The forward saves the
    four slabs, its per-tile chunk count and the tile counts; the backward
    replays exactly those chunks, up to each tile's count. ``tile_counts``
    gets no gradient."""

    @staticmethod
    def forward(ctx, g_means, g_conics, g_colors, g_opac, num_tiles_x,
                tile_size, tile_counts, k_chunk):
        runs = torch.empty(g_colors.shape[0], dtype=torch.int32,
                           device=g_colors.device)
        out, acc = _composite(g_means, g_conics, g_colors, g_opac,
                              num_tiles_x, tile_size, tile_counts, k_chunk,
                              runs)
        ctx.save_for_backward(g_means, g_conics, g_colors, g_opac, runs,
                              tile_counts)
        ctx.num_tiles_x, ctx.tile_size, ctx.k_chunk = (
            num_tiles_x, tile_size, k_chunk)
        ctx.mark_non_differentiable(runs)
        return out, acc, runs

    @staticmethod
    @once_differentiable
    def backward(ctx, gout, gacc, _):
        means, conics, colors, opac, runs, counts = ctx.saved_tensors
        grads = composite_tiles_bwd(
            means, conics, colors, opac, gout.contiguous(),
            gacc.contiguous(), ctx.num_tiles_x, ctx.tile_size, ctx.k_chunk,
            runs, counts)
        return (*grads, None, None, None, None)


def _composite_autograd(g_means, g_conics, g_colors, g_opac, num_tiles_x,
                        tile_size, tile_counts, k_chunk, chunks_run):
    out, acc, runs = _Composite.apply(g_means, g_conics, g_colors, g_opac,
                                      num_tiles_x, tile_size, tile_counts,
                                      k_chunk)
    if chunks_run is not None:
        chunks_run.copy_(runs)
    return out, acc


def composite_tiles(g_means, g_conics, g_colors, g_opac, num_tiles_x: int,
                    tile_size: int = 16):
    """Composite gathered per-tile gaussians -> ([T, D, P], [T, 1, P])."""
    return _composite_autograd(g_means, g_conics, g_colors, g_opac,
                               num_tiles_x, tile_size, None, 0, None)


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
    return _composite_autograd(g_means, g_conics, g_colors, g_opac,
                               num_tiles_x, tile_size, tile_counts, k_chunk,
                               chunks_run)


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
    absgrad_seed: Optional[torch.Tensor] = None,
) -> RasterizeResult:
    """Render of binned gaussians through the compositing kernels,
    addressed by depth rank as the JAX hot path does: gather
    ``params[order]`` once, then each tile's slots by rank. Differentiable;
    ``absgrad_seed`` (zeros [N, 2]) receives as its gradient the
    per-gaussian sums of |slot screen-mean gradients| (see
    ``ops.segment.tile_gather_ranked``)."""
    t, k = tile_ranks.shape
    d = colors.shape[-1]
    num_tiles_y = -(-t // num_tiles_x)
    if num_tiles_x * num_tiles_y != t:
        raise ValueError("tile grid mismatch")
    packed = torch.cat([means2d, conics, colors, opacities[:, None]],
                       dim=-1).to(torch.float32)      # [N, 6 + D]
    g = tile_gather_ranked(packed, order, tile_ranks, absgrad_seed)
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
