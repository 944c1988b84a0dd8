"""Tile compositing through the hand-written CUDA kernels, forward and
backward.

Counterpart of ``qed_splatter_tpu.ops.rasterize_pallas`` (the module name is
kept so each function's counterpart is easy to find; nothing here is
Pallas). The channel-major interface is the JAX module's: slabs
``[T, C, K]`` in, ``[T, D, P]`` colour and ``[T, 1, P]`` accumulated alpha
out (P = 256 pixels of a 16x16 tile).

- ``csrc/composite.cu`` is the forward (``_fwd_kernel``, ``_fwd_kernel_skip``).
  In training it also hands the backward, per pixel, the last transmittance
  it carried (``t_last``) and the slot where it stopped carrying it
  (``cut``).
- ``csrc/composite_bwd.cu`` is the analytic backward (``_bwd_kernel``,
  ``_bwd_kernel_skip``): one back-to-front sweep that divides T back out of
  ``t_last`` and carries what lies behind each slot. It replays exactly the
  chunks the forward composited (the forward's per-tile ``chunks_run``) and
  stops at the tile's count.

Forward, backward and their plain versions define one function of (slabs,
``tile_counts``): with counts, the slots at or past a tile's count are
padding, whatever they hold; they are never composited and get exact zero
gradients. (The binning leaves them with opacity 0, where this is what the
JAX package computes too.)

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
# The forward stops handing T on below this (float32's normal range ends at
# 1.2e-38); gradients behind are zero.
TRANS_MIN = 1e-30

COMPOSITE = CudaKernel(
    "composite", "qed_composite_tiles",
    [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 5 + [ctypes.c_float],
)
COMPOSITE_BWD = CudaKernel(
    "composite_bwd", "qed_composite_tiles_bwd",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5,
)
_NULL = ctypes.c_void_p(None)


def _alpha_local(means, conics, opac, tile_idx, num_tiles_x, tile_size,
                 run=None):
    """Alpha of one group of tiles on all their pixels, [Tc, P, K], in
    tile-local coordinates and the kernels' op order. ``run`` ([Tc, K] bool)
    marks the slots that are composited; the rest have alpha 0 whatever they
    hold. Returns (dx, dy, e^-sigma, op e^-sigma, mask, alpha)."""
    dev, dt = means.device, means.dtype
    half = tile_size * 0.5
    ox = ((tile_idx % num_tiles_x) * tile_size).to(dt)
    oy = ((tile_idx // num_tiles_x) * tile_size).to(dt)
    pix = torch.arange(tile_size * tile_size, device=dev)
    pxl = (pix % tile_size).to(dt) + (0.5 - half)              # [P]
    pyl = (pix // tile_size).to(dt) + (0.5 - half)
    mxl = means[:, 0, :] - (ox + half)[:, None]                # [Tc, K]
    myl = means[:, 1, :] - (oy + half)[:, None]
    dx = mxl[:, None, :] - pxl[None, :, None]                  # [Tc, P, K]
    dy = myl[:, None, :] - pyl[None, :, None]
    ca = conics[:, None, 0, :]
    cb = conics[:, None, 1, :]
    cc = conics[:, None, 2, :]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    e = torch.exp(-sigma)
    a_raw = opac[:, None, 0, :] * e
    keep = (sigma >= 0.0) & (a_raw > ALPHA_EPS)
    if run is not None:
        keep = keep & run[:, None, :]
    alpha = torch.where(keep, torch.clamp(a_raw, max=ALPHA_MAX), 0.0)
    return dx, dy, e, a_raw, keep, alpha


def _composite_local(means, conics, colors, opac, tile_idx, num_tiles_x,
                     tile_size, run=None):
    """Plain composite of one group of tiles over its slots (those that
    ``run`` [Tc, K] marks; all K without it), alpha in tile-local
    coordinates as the kernel evaluates it. [Tc, D, P], [Tc, 1, P]."""
    alpha = _alpha_local(means, conics, opac, tile_idx, num_tiles_x,
                         tile_size, run)[-1]
    if run is not None:
        colors = torch.where(run[:, None, :], colors, 0.0)
    w = alpha * excl_transmittance(alpha)                      # [Tc, P, K]
    out = (w[:, None, :, :] * colors[:, :, None, :]).sum(-1)   # [Tc, D, P]
    return out, w.sum(-1)[:, None, :]


def _composite_group(means, conics, colors, opac, tile_idx, num_tiles_x,
                     tile_size, k_chunk, live, run=None):
    """One group of tiles over depth chunks of ``k_chunk`` (all K when 0),
    composed as ``out_A + (1 - acc_A) out_B``. ``live(s, acc)`` -> [Tc] bool
    says which tiles composite the chunk starting at s; a tile that does not
    sees that chunk as zeros (no contribution, exact zero gradients).
    ``run`` ([Tc, K] bool) marks the slots below each tile's count.
    Returns (out, acc, chunks run [Tc] int32)."""
    tc, _, k = colors.shape
    runs = torch.full((tc,), 1 if k > 0 else 0, dtype=torch.int32,
                      device=colors.device)
    if k_chunk <= 0 or k <= k_chunk:
        out, acc = _composite_local(means, conics, colors, opac, tile_idx,
                                    num_tiles_x, tile_size, run)
        return out, acc, runs
    out = acc = None
    for s in range(0, k, k_chunk):
        parts = [x[..., s:s + k_chunk] for x in (means, conics, colors, opac)]
        run_s = None if run is None else run[:, s:s + k_chunk]
        if out is None:
            out, acc = _composite_local(*parts, tile_idx, num_tiles_x,
                                        tile_size, run_s)
            continue
        on = live(s, acc.detach())
        runs = runs + on.to(torch.int32)
        parts = [torch.where(on[:, None, None], x, 0.0) for x in parts]
        o, a = _composite_local(*parts, tile_idx, num_tiles_x, tile_size,
                                run_s)
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


def _slots_below(counts, k):
    """[Tc, K] bool: the slots below each tile's count (None without
    counts: every slot)."""
    if counts is None:
        return None
    return torch.arange(k, device=counts.device)[None, :] < counts[:, None]


def composite_tiles_ref(
    g_means: torch.Tensor,    # [T, 2, K]
    g_conics: torch.Tensor,   # [T, 3, K]
    g_colors: torch.Tensor,   # [T, D, K]
    g_opac: torch.Tensor,     # [T, 1, K]
    num_tiles_x: int,
    tile_size: int = 16,
    tile_counts: Optional[torch.Tensor] = None,
    k_chunk: int = 0,
    chunks_run: Optional[torch.Tensor] = None,
    tail: bool = False,
):
    """Plain version of the compositing kernel: transmittance as an
    exclusive ``cumprod`` along K, tiles in groups under a memory budget.
    With ``tile_counts`` the slots at or past a tile's count are padding:
    they are not composited, whatever they hold.

    ``k_chunk > 0`` composes depth chunks of that length as
    ``composite_tiles_chunked`` does: out += (1 - acc) * out_chunk for the
    tiles where the chunk is live, zero elsewhere. ``chunks_run`` ([T]
    int32), when given, receives the number of chunks each tile composited.
    Returns (out, acc) and, with ``tail``, also what the kernel hands its
    backward: (out, acc, t_last, cut) of :func:`transmittance_tail_ref` over
    the slots each tile composited."""
    t, _, k = g_colors.shape
    dev = g_colors.device
    live_counts = tile_counts
    if live_counts is None:
        live_counts = torch.full((t,), k, dtype=torch.int32, device=dev)
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
            _forward_live(live_counts[sl]),
            _slots_below(None if tile_counts is None else tile_counts[sl], k))
        outs.append(o)
        accs.append(a)
        runs.append(r)
    runs = torch.cat(runs)
    if chunks_run is not None:
        chunks_run.copy_(runs)
    out, acc = torch.cat(outs), torch.cat(accs)
    if not tail:
        return out, acc
    n_run = slots_run(t, k, k_chunk, runs, tile_counts, dev)
    return (out, acc, *transmittance_tail_ref(
        g_means, g_conics, g_opac, num_tiles_x, tile_size, n_run))


def _tail_from_alpha(alpha, n_run):
    """T carried front to back, slot by slot, as the forward kernel carries
    it (``alpha`` [Tc, P, K], 0 past ``n_run`` [Tc]): the last T that was
    still >= ``TRANS_MIN`` ([Tc, P]) and the slot whose alpha took it below
    (int32 [Tc, P]; ``n_run`` where none did)."""
    tc, p, _ = alpha.shape
    trans = torch.ones((tc, p), dtype=alpha.dtype, device=alpha.device)
    cut = torch.full((tc, p), -1, dtype=torch.int32, device=alpha.device)
    for j in range(int(n_run.max()) if tc else 0):
        nxt = trans * (1.0 - alpha[..., j])
        cut = torch.where((cut < 0) & (nxt < TRANS_MIN), j, cut)
        trans = torch.where(cut < 0, nxt, trans)
    return trans, torch.where(cut < 0, n_run[:, None].to(torch.int32), cut)


def transmittance_tail_ref(g_means, g_conics, g_opac, num_tiles_x: int,
                           tile_size: int, n_run: torch.Tensor):
    """Plain version of what the forward kernel hands the backward, over the
    first ``n_run[t]`` slots of each tile: ``t_last`` ([T, 1, P], the last
    exclusive transmittance >= ``TRANS_MIN``) and ``cut`` (int32 [T, 1, P],
    the slot it belongs to: T_cut = t_last, T is taken as 0 behind it;
    ``n_run[t]`` where T never fell below). The product is taken slot by
    slot in the kernel's order, so the two agree bit for bit."""
    t, _, k = g_means.shape
    dev = g_means.device
    step = tile_chunk_size(t, tile_size * tile_size, k, dev)
    tid = torch.arange(t, device=dev)
    lasts, cuts = [], []
    for s in range(0, t, step):
        sl = slice(s, s + step)
        alpha = _alpha_local(g_means[sl], g_conics[sl], g_opac[sl], tid[sl],
                             num_tiles_x, tile_size,
                             _slots_below(n_run[sl], k))[-1]
        last, cut = _tail_from_alpha(alpha, n_run[sl])
        lasts.append(last)
        cuts.append(cut)
    return torch.cat(lasts)[:, None, :], torch.cat(cuts)[:, None, :]


def composite_tiles_bwd_ref(
    g_means, g_conics, g_colors, g_opac,   # the forward's slabs
    gout: torch.Tensor,                    # [T, D, P] cotangent of out
    gacc: torch.Tensor,                    # [T, 1, P] cotangent of acc
    num_tiles_x: int,
    tile_size: int = 16,
    k_chunk: int = 0,
    chunks_run: Optional[torch.Tensor] = None,
    tile_counts: Optional[torch.Tensor] = None,
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
            o, a, _ = _composite_group(
                *leaves, tid[sl], num_tiles_x, tile_size,
                k_chunk if chunked else 0, live, _slots_below(
                    None if tile_counts is None else tile_counts[sl], k))
            part = torch.autograd.grad((o, a), leaves, (gout[sl], gacc[sl]),
                                       allow_unused=True)
        for g, d in zip(grads, part):
            if d is not None:
                g[sl] = d
    return tuple(grads)


def slots_run(t, k, k_chunk, chunks_run, tile_counts, device):
    """[T] int64: how many leading slots of each tile forward and backward
    run, ``min(chunks_run * k_chunk, tile_counts, K)`` over what is given."""
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
    t_last: Optional[torch.Tensor] = None,
    cut: Optional[torch.Tensor] = None,
):
    """Plain version of the backward kernel's algorithm, one group of tiles
    at a time: the direct chain rule with

      dalpha_k = T_k (dw_k - Q_k),

    in one back-to-front sweep that carries Q_k, what lies behind slot k
    composited on its own (Q_{k-1} = alpha_k dw_k + (1 - alpha_k) Q_k), and
    T_k = T_{k+1} / (1 - alpha_k), starting from what the forward hands
    over: ``t_last`` ([T, 1, P]) at slot ``cut`` (int32 [T, 1, P]), zero
    behind it. Without them the front-to-back sweep that gives them runs
    here (:func:`_tail_from_alpha`), with the same result. Only the slots
    :func:`slots_run` counts are replayed; the rest get exact zeros.
    Returns (dmeans, dconics, dcolors, dopac).

    ``total`` ([T, P], S = sum_c gout_c out_c + gacc acc of the forward's
    outputs) selects the one-sweep form instead, which the kernel does not
    use: dalpha_k = T_k dw_k - (S - prefix_k) / (1 - alpha_k), front to
    back only. It is here so that its error can be measured."""
    t, d, k = g_colors.shape
    dev = g_colors.device
    dt = g_colors.dtype
    chunked = 0 < k_chunk < k
    if chunked and chunks_run is None:
        raise ValueError("a chunked backward needs the forward's chunks_run")
    if (t_last is None) != (cut is None):
        raise ValueError("t_last and cut come together")
    n_run = slots_run(t, k, k_chunk, chunks_run if chunked else None,
                      tile_counts, dev)
    grads = [torch.zeros_like(x) for x in (g_means, g_conics, g_colors,
                                           g_opac)]
    p = tile_size * tile_size
    step = max(1, tile_chunk_size(t, p, k, dev) // BWD_GROUP_DIVISOR)
    zero = torch.zeros((), dtype=dt, device=dev)
    for s in range(0, t, step):
        sl = slice(s, s + step)
        tid = torch.arange(s, min(s + step, t), device=dev)
        run = _slots_below(n_run[sl], k)                       # [Tc, K]
        n_max = int(n_run[sl].max()) if tid.numel() else 0
        dx, dy, e, a_raw, keep, alpha = _alpha_local(
            g_means[sl], g_conics[sl], g_opac[sl], tid, num_tiles_x,
            tile_size, run)                                    # [Tc, P, K]
        go = gout[sl]                                          # [Tc, D, P]
        colors = torch.where(run[:, None, :], g_colors[sl], zero)
        dw = gacc[sl, 0, :, None] + torch.einsum("tdp,tdk->tpk", go, colors)
        if total is None:
            if t_last is None:
                trans, stop = _tail_from_alpha(alpha, n_run[sl])
            else:
                trans, stop = t_last[sl, 0], cut[sl, 0]
            dw_k = dw.permute(2, 0, 1).contiguous()            # [K, Tc, P]
            alpha_k = alpha.permute(2, 0, 1).contiguous()
            dalpha_k = torch.zeros_like(dw_k)
            w_k = torch.zeros_like(dw_k)
            behind = torch.zeros_like(dw_k[0])                 # Q, [Tc, P]
            for j in range(n_max - 1, -1, -1):
                trans = torch.where(stop > j, trans / (1.0 - alpha_k[j]),
                                    trans)                     # T_j
                tk = torch.where(stop < j, zero, trans)
                diff = dw_k[j] - behind
                dalpha_k[j] = tk * diff
                w_k[j] = alpha_k[j] * tk
                behind = behind + alpha_k[j] * diff
            dalpha = dalpha_k.permute(1, 2, 0)
            w = w_k.permute(1, 2, 0)
        else:
            trans = excl_transmittance(alpha)
            trans = torch.where(trans >= TRANS_MIN, trans, zero)
            w = alpha * trans
            rest = total[sl, :, None] - torch.cumsum(w * dw, dim=-1)
            dalpha = trans * dw - rest / (1.0 - alpha)
        da = torch.where(keep & (a_raw <= ALPHA_MAX), dalpha, zero)
        dsig = -a_raw * da
        r0 = (dsig * dx).sum(1)                                # [Tc, K]
        r1 = (dsig * dy).sum(1)
        cak, cbk, cck = (g_conics[sl, c] for c in range(3))

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


def composite_tiles_fwd(g_means, g_conics, g_colors, g_opac,
                        num_tiles_x: int, tile_size: int = 16,
                        tile_counts: Optional[torch.Tensor] = None,
                        k_chunk: int = 0,
                        chunks_run: Optional[torch.Tensor] = None,
                        tail: bool = False):
    """Forward of the compositor, without autograd: ``csrc/composite.cu`` on
    CUDA tensors, :func:`composite_tiles_ref` on CPU ones. With
    ``tile_counts`` (int32 [T]) a tile composites the slots below its count;
    those at or past it are padding and are never read. ``chunks_run``
    ([T] int32) receives the chunks each tile composited. Returns
    (out, acc, t_last, cut): the last two are what the backward takes
    (:func:`transmittance_tail_ref`) with ``tail``, else None."""
    _check_slabs(g_means, g_conics, g_colors, g_opac, tile_counts,
                 chunks_run)
    t, d, k = g_colors.shape
    if g_colors.device.type == "cpu":
        res = composite_tiles_ref(g_means, g_conics, g_colors, g_opac,
                                  num_tiles_x, tile_size, tile_counts,
                                  k_chunk, chunks_run, tail)
        return res if tail else (*res, None, None)
    _check_cuda_shapes(tile_size, d)
    dev = g_colors.device
    ins = [x.contiguous() for x in (g_means, g_conics, g_colors, g_opac)]
    counts = tile_counts.contiguous() if tile_counts is not None else None
    p = tile_size * tile_size
    out = torch.empty((t, d, p), dtype=torch.float32, device=dev)
    acc = torch.empty((t, 1, p), dtype=torch.float32, device=dev)
    t_last = cut = None
    if tail:
        t_last = torch.empty((t, 1, p), dtype=torch.float32, device=dev)
        cut = torch.empty((t, 1, p), dtype=torch.int32, device=dev)
    COMPOSITE(
        *(ptr(x) for x in ins),
        *(ptr(x) if x is not None else _NULL
          for x in (counts, out, acc, chunks_run, t_last, cut)),
        t, k, d, num_tiles_x, k_chunk, EARLY_STOP_EPS,
        variant="chunked" if 0 < k_chunk < k else "",
    )
    return out, acc, t_last, cut


def composite_tiles_bwd(g_means, g_conics, g_colors, g_opac, gout, gacc,
                        num_tiles_x: int, tile_size: int, k_chunk: int,
                        chunks_run: torch.Tensor,
                        tile_counts: Optional[torch.Tensor],
                        t_last: torch.Tensor, cut: torch.Tensor):
    """Backward of the compositor, from the forward's slabs, the chunks it
    ran (``chunks_run`` [T] int32) and what it handed over (``t_last``
    float32 and ``cut`` int32, both [T, 1, P], from
    :func:`composite_tiles_fwd` with ``tail`` and the same ``tile_counts``).
    With ``tile_counts`` (int32 [T]) a tile stops at its count: slots at or
    past it are padding. ``csrc/composite_bwd.cu`` on CUDA tensors,
    :func:`composite_tiles_bwd_sweeps_ref` on CPU tensors. Returns
    (dmeans, dconics, dcolors, dopac), exact zeros past each tile's
    replayed slots."""
    _check_slabs(g_means, g_conics, g_colors, g_opac, tile_counts,
                 chunks_run)
    t, d, k = g_colors.shape
    p = tile_size * tile_size
    dev = g_colors.device
    if t_last is None or cut is None:
        raise ValueError("the backward takes the forward's t_last and cut "
                         "(composite_tiles_fwd with tail=True)")
    for name, x, c, dtype in (("gout", gout, d, torch.float32),
                              ("gacc", gacc, 1, torch.float32),
                              ("t_last", t_last, 1, torch.float32),
                              ("cut", cut, 1, torch.int32)):
        if x.dtype != dtype or tuple(x.shape) != (t, c, p):
            raise ValueError(f"{name} must be {dtype} [{t}, {c}, {p}]")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, colors on {dev}")
    if dev.type == "cpu":
        return composite_tiles_bwd_sweeps_ref(
            g_means, g_conics, g_colors, g_opac, gout, gacc, num_tiles_x,
            tile_size, k_chunk, chunks_run, tile_counts, t_last=t_last,
            cut=cut)
    _check_cuda_shapes(tile_size, d)
    ins = [x.contiguous() for x in (g_means, g_conics, g_colors, g_opac,
                                    gout, gacc, chunks_run)]
    tails = [t_last.contiguous(), cut.contiguous()]
    counts = (ptr(tile_counts.contiguous()) if tile_counts is not None
              else _NULL)
    grads = [torch.empty_like(x) for x in ins[:4]]
    COMPOSITE_BWD(
        *(ptr(x) for x in ins), counts, *(ptr(x) for x in tails),
        *(ptr(x) for x in grads), t, k, d, num_tiles_x, k_chunk,
        variant="chunked" if 0 < k_chunk < k else "",
    )
    return tuple(grads)


class _Composite(torch.autograd.Function):
    """The compositor with the analytic backward. The forward saves the
    four slabs, its per-tile chunk count, the tile counts and, per pixel,
    the transmittance it ended on (``t_last``, ``cut``); the backward
    replays exactly those chunks, up to each tile's count, dividing T back
    out of ``t_last``. ``tail`` is False where no gradient will be asked
    for: the forward then writes no ``t_last`` and ``cut``. ``tile_counts``
    gets no gradient."""

    @staticmethod
    def forward(ctx, g_means, g_conics, g_colors, g_opac, num_tiles_x,
                tile_size, tile_counts, k_chunk, tail):
        runs = torch.empty(g_colors.shape[0], dtype=torch.int32,
                           device=g_colors.device)
        out, acc, t_last, cut = composite_tiles_fwd(
            g_means, g_conics, g_colors, g_opac, num_tiles_x, tile_size,
            tile_counts, k_chunk, runs, tail)
        ctx.save_for_backward(g_means, g_conics, g_colors, g_opac, runs,
                              tile_counts, t_last, cut)
        ctx.num_tiles_x, ctx.tile_size, ctx.k_chunk = (
            num_tiles_x, tile_size, k_chunk)
        ctx.mark_non_differentiable(runs)
        return out, acc, runs

    @staticmethod
    @once_differentiable
    def backward(ctx, gout, gacc, _):
        (means, conics, colors, opac, runs, counts, t_last,
         cut) = ctx.saved_tensors
        grads = composite_tiles_bwd(
            means, conics, colors, opac, gout.contiguous(),
            gacc.contiguous(), ctx.num_tiles_x, ctx.tile_size, ctx.k_chunk,
            runs, counts, t_last, cut)
        return (*grads, None, None, None, None, None)


def _composite_autograd(g_means, g_conics, g_colors, g_opac, num_tiles_x,
                        tile_size, tile_counts, k_chunk, chunks_run):
    # the forward hands T to the backward only where there will be one
    tail = torch.is_grad_enabled() and any(
        x.requires_grad for x in (g_means, g_conics, g_colors, g_opac))
    out, acc, runs = _Composite.apply(g_means, g_conics, g_colors, g_opac,
                                      num_tiles_x, tile_size, tile_counts,
                                      k_chunk, tail)
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
    on chunks that hold only padding. With ``tile_counts`` the slots at or
    past a tile's count are padding: never composited, zero gradients.
    ``chunks_run`` (int32 [T]) receives the number of chunks each tile
    composited."""
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
