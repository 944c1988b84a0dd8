#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``qed_splatter_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases (any failure exits non-zero):
1. build every CUDA kernel under ``qed_splatter_tpu_torch/csrc`` with nvcc;
2. hold each forward kernel against its plain PyTorch version on seeded
   random inputs at the render path's shapes: the compositor without counts,
   with tile counts well below K (and counts of 0, 1, K and past K) at
   K = 256, an odd K and chunked at K = 2048, where it must stop at the
   count (slots past it poisoned with NaN change nothing) and hand the
   backward, bit for bit, the transmittance the plain version carries; the
   window gather in both of its modes (the plain gather, and the gather
   fused with the rank mask) at K = 256, 1024, 2048 and an odd K;
2b. hold the compositing backward kernel, fed by the forward kernel's
   transmittance, against its plain version on random slabs and cotangents,
   unchunked (K = 256) and chunked (K = 2048, chunk 2 composited on some
   tiles, both skip reasons firing), each also with tile counts well below K
   (exact zeros past the count), and under 24-deep opaque stacks, where the
   transmittance falls below float32;
2c. hold the mixed_precision (bf16 operand) kernels against their
   plain versions on random slabs: K = 256 (two 128-slot blocks) with
   counts, K = 333 with counts of 0, 1, K and past K, 24-deep opaque stacks,
   and chunked at K = 2048; the forward's handoff (block offsets and sums
   of the rounded logs, chunk transmittances) feeds the backward;
3. scene A (the bench's canonical point): 131,072 capacity / 80,000 alive,
   SH degree 3, K = 256, 1296x840, 4 orbit cameras through
   ``render(train=False)``;
4. scene B (the adaptive-K dense regime): 327,680 / 288,000, K = 2048,
   2 cameras, which takes the compositor's chunked path;
train A. ``bench.py``'s canonical training point on scene A: SO3xR3 camera
   opt, depth supervision, random background, the default optimizers,
   absgrad on; 3 warm-up and 20 timed steps of ``make_train_step``;
train B. scene B at K = 2048: 3 steps, the chunked backward;
train A/B mixed. scenes A and B trained with ``mixed_precision`` (3 and 2
   steps; B takes the chunked mixed kernels): one step's gradients against
   the float32 step's within the bf16 envelope (5e-2 of each tensor's max),
   both mixed kernels held and timed on that step's inputs;
bench. ``python -m qed_splatter_tpu_torch.bench``'s three points
   (``bench.py``'s: 80k / K = 256, 288k / K = 1024, and 80k / K = 256 with
   ``mixed_precision``), shortened to 3 + 3 steps (2 + 2 at the dense
   point); prints the bench line;
tools. the ported microbenchmarks ``tools/bench_gather.py`` (the window
   gather on 4-byte keys, kernel #6) and ``tools/bench_gather3.py`` (the
   identity copy, kernel #7), each kernel bit-equal to its plain version;
trainer. the port's ``Trainer`` on a room RGB-D dataset written by
   ``testing.write_room_dataset`` (14 frames at 1296x840, 40,000 seed
   points): 400 steps, the first 200 at half resolution, refine every 50
   after a warm-up of 100, an opacity reset at step 250, a capacity that
   grows at the first refine, adaptive K from 256, a checkpoint at step 200,
   ``eval_all`` before and after, ``finalize``, ``profile_dir`` (a
   ``torch.profiler`` trace of steps 10-14 of each ``train`` call, which
   must name both compositing kernels); then one step's gradients on the
   trained state against the plain path, with the pixels on another branch
   of the loss counted by kind and the alpha masks that flip between the
   two paths counted (none may), and a resume from the step-200
   checkpoint (its state equal to the one saved, tensor for tensor) for 20
   more steps. It fails unless a refine added gaussians, the capacity grew,
   all three kernels launched, at least 150 steps ran at 1296x840, every
   loss was finite and eval PSNR rose.

Each render or train phase resets the kernels' launch counts, drives the
path, and fails unless every kernel of the path launched at least once per
frame or step; checks finite outputs; matches one frame or one step's
gradients against the plain path (``use_pallas=False``) on the card; holds
each kernel against its plain version on that run's own inputs; and times
the frame or step, each kernel, its plain version and its bound. The window
gather runs for microseconds, less than a launch costs the host, so its
times (kernel, plain version and library call alike) are taken from replays
of a captured CUDA graph; so is the compositing forward's, whose 0.2 ms is
of the order of what its differentiable entry point costs the host. A
step's gradients are held against the plain path on the state after the
steps and on the scene before any step; a pixel within rounding of a kink
of the loss, where the two paths' gradients differ by that pixel's whole
weight, is counted and masked out of both.

Prints the bench line, the tools' times, ``render_ms_per_frame`` /
``train_ms_per_step`` / ``bench`` / ``trainer`` and ``kernels`` JSON lines,
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. The gather's row in ``kernels`` is its
rank mode, the one the main path launches; the gather mode's numbers are
under that row's ``gather_mode`` key. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1296, 840
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TOL = 1e-4                   # the reference's own on-chip forward parity bar
# backward bar: per output channel, max |kernel - plain| over max |plain|
# (warp shuffles, index_add_ atomics and autograd sum in other orders)
BWD_TOL = 1e-3
# a step's gradients against the plain path on the scene before any step
# (readings: 4e-7)
FRESH_TOL = 1e-5
# the bf16 envelope: a mixed step's gradients against the float32 step's,
# per tensor over its max |grad| (the JAX package holds its own mixed VJP to
# this bar against float32)
MIXED_TOL = 5e-2
RP = "qed_splatter_tpu/ops/rasterize_pallas.py"
REPLACES = {
    "composite": f"{RP}:231 _fwd_kernel; {RP}:241 _fwd_kernel_skip",
    "composite_bwd": f"{RP}:297 _bwd_kernel; {RP}:268 _bwd_kernel_skip",
    "composite_mixed": (f"{RP}:231 _fwd_kernel with op_dtype=bfloat16 "
                        f"(:444)"),
    "composite_mixed_chunked": (f"{RP}:241 _fwd_kernel_skip with "
                                f"op_dtype=bfloat16 (:575)"),
    "composite_bwd_mixed": (f"{RP}:297 _bwd_kernel with op_dtype=bfloat16 "
                            f"(:489)"),
    "composite_bwd_mixed_chunked": (f"{RP}:268 _bwd_kernel_skip with "
                                    f"op_dtype=bfloat16 (:627)"),
    "slab_gather": "qed_splatter_tpu/ops/tiles.py:67 _slab_kernel",
    "slab_gather_i32": "tools/bench_gather.py:102 slab_kernel",
    "copy_rows": "tools/bench_gather3.py:46 pallas_copy.kern",
}
CSRC = "qed_splatter_tpu_torch/csrc"
SOURCES = {"composite": f"{CSRC}/composite.cu",
           "composite_bwd": f"{CSRC}/composite_bwd.cu",
           "composite_mixed": f"{CSRC}/composite.cu",
           "composite_mixed_chunked": f"{CSRC}/composite.cu",
           "composite_bwd_mixed": f"{CSRC}/composite_bwd.cu",
           "composite_bwd_mixed_chunked": f"{CSRC}/composite_bwd.cu",
           "slab_gather": f"{CSRC}/slab_gather.cu",
           "slab_gather_i32": f"{CSRC}/slab_gather.cu",
           "copy_rows": f"{CSRC}/copy_rows.cu"}
TRAIN_STEPS_WARM, TRAIN_STEPS_TIMED = 3, 20
# the bench's three points, shortened: warm-up and timed steps of each
BENCH_TIMED, BENCH_DENSE_TIMED = 3, 2


def fwd_ops_per_pair(d):
    """f32 ops per (pixel, slot) of composite.cu."""
    return 20 + 2 * d


def bwd_ops_per_pair(d):
    """f32 ops per (pixel, slot) that the compositing backward needs: the
    recompute of alpha, T and dw (23 + 2D), the transmittance chain and the
    6 + D per-pixel terms (20 + 2D, one add per pixel for each term's sum
    over the tile; the shuffles that move the terms are not counted).
    T comes from the forward kernel (8 bytes per pixel), so no second
    front-to-back pass is part of the work."""
    return 43 + 4 * d


def fwd_mixed_ops_per_pair(d):
    """f32 ops per (pixel, slot) of composite.cu's mixed kernel: the f32
    kernel's, less T's product (2), plus the log of 1 - alpha (3), E from
    the block's offset and integer sum (3) and its exp (1), the integer sum
    of the rounded log (4) and the unrounded sum (1), w's rounding (2)."""
    return fwd_ops_per_pair(d) + 12


def bwd_mixed_ops_per_pair(d):
    """f32 ops per (pixel, slot) of composite_bwd.cu's mixed kernel: the f32
    kernel's, less T's division (2), plus the log (3), the integer sum taken
    back (4), E and its exp (4), w's rounding (2), and the chunk's out and
    acc summed in the sweep (2D)."""
    return bwd_ops_per_pair(d) + 11 + 2 * d


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls issued from the host after one
    warm-up, between two CUDA events (``utils/microbench.py``)."""
    from qed_splatter_tpu_torch.utils import microbench

    return microbench.device_time_per_call(fn, (), n=reps, graph=False) * 1e3


def graph_ms(fn, reps):
    """Mean ms per call of ``fn`` on the device alone: ``reps`` calls
    captured into one CUDA graph, whose replays are timed
    (``utils/microbench.py``), so the host's launch cost (which exceeds a
    kernel of a few microseconds) is not in the number. Fails where ``fn``
    could not be captured."""
    from qed_splatter_tpu_torch.utils import microbench

    ms = microbench.device_time_per_call(fn, (), n=reps) * 1e3
    if microbench.last_method != "graph":
        raise SmokeFailure("a kernel could not be captured in a CUDA graph")
    return ms


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2

def random_slabs(gen, t, k, d, counts, num_tiles_x, saturate=None, depth=8):
    """Channel-major slabs of plausible splats around each tile; slots at or
    past ``counts[t]`` are padding (opacity 0), as the binning leaves them.
    Tiles marked by ``saturate`` start with ``depth`` slots of alpha 0.999
    over the whole tile."""
    dev = "cuda"

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    tid = torch.arange(t, device=dev)
    ox = ((tid % num_tiles_x) * 16).float()[:, None]
    oy = ((tid // num_tiles_x) * 16).float()[:, None]
    means = torch.stack([ox + u(-12, 28, t, k), oy + u(-12, 28, t, k)], 1)
    sx, sy = u(0.7, 6.0, t, k), u(0.7, 6.0, t, k)
    rho = u(-0.8, 0.8, t, k)
    det = (sx * sy) ** 2 * (1 - rho * rho)
    conics = torch.stack([sy * sy / det, -rho * sx * sy / det,
                          sx * sx / det], 1)
    opac = u(0.02, 0.35, t, k)
    colors = u(0.0, 1.0, t, d, k)
    colors[:, d - 1] = u(1.0, 5.0, t, k)          # a depth channel
    slot = torch.arange(k, device=dev)[None, :]
    opac = torch.where(slot < counts[:, None], opac, 0.0)
    if saturate is not None:                      # opaque stack in chunk 1
        means[saturate, :, :depth] = torch.stack([ox, oy], 1)[saturate] + 8.0
        conics[saturate, 0, :depth] = 1e-6
        conics[saturate, 1, :depth] = 0.0
        conics[saturate, 2, :depth] = 1e-6
        opac[saturate, :depth] = 0.999
    return [x.contiguous() for x in (means, conics, colors, opac[:, None])]


def chunked_case(gen, t, d, num_tiles_x, k=2048):
    """Slabs and tile counts for the chunked compositor, K past one chunk:
    a third of the tiles' counts end inside chunk 1, a sixth start with an
    opaque stack (saturated in chunk 1), the rest composite both chunks."""
    from qed_splatter_tpu_torch.ops.rasterize_pallas import K_CHUNK

    counts = torch.randint(1, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[: t // 3] = torch.randint(1, K_CHUNK + 1, (t // 3,),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
    saturate = torch.zeros(t, dtype=torch.bool, device="cuda")
    saturate[t // 3: t // 2] = True
    counts[saturate] = k
    return random_slabs(gen, t, k, d, counts, num_tiles_x, saturate), counts


def check_fwd(slabs, ntx, counts, k_chunk, label, poison=False):
    """The forward kernel with its handoff against the plain version on the
    same slabs and counts: out and acc within TOL, chunks run equal, t_last
    and cut equal bit for bit. With ``poison`` also: NaN in the means, conics
    and colours at and past each tile's count (opacity 0 kept) leaves every
    output of the kernel bit-equal. Returns (chunks run, t_last, cut,
    max abs err)."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, _, k = slabs[2].shape
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    got = rp.composite_tiles_fwd(*slabs, ntx, 16, counts, k_chunk, runs,
                                 tail=True)
    want = rp.composite_tiles_ref(*slabs, ntx, 16, counts, k_chunk, runs_ref,
                                  tail=True)
    err = max(max_abs(got[0], want[0]), max_abs(got[1], want[1]))
    n_run = rp.slots_run(t, k, k_chunk, runs, counts, "cuda")
    below = int((got[3][:, 0] < n_run[:, None]).sum())
    print(f"  {label}: max_abs_err {err:.3e}; pixels whose T fell below "
          f"{rp.TRANS_MIN:g}: {below}")
    check(err <= TOL, f"{label} within {TOL}")
    check(torch.equal(runs, runs_ref), f"{label}: chunks run per tile equal "
          "the plain")
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          f"{label}: t_last and cut equal the plain version bit for bit")
    if poison:
        slot = torch.arange(k, device="cuda")[None, None, :]
        past = slot >= counts[:, None, None]
        bad = [torch.where(past, float("nan"), x) for x in slabs[:3]]
        runs_p = torch.empty_like(runs)
        again = rp.composite_tiles_fwd(*bad, slabs[3], ntx, 16, counts,
                                       k_chunk, runs_p, tail=True)
        check(all(bool(torch.isfinite(x).all()) for x in again[:3])
              and all(torch.equal(a, b) for a, b in zip(again, got))
              and torch.equal(runs_p, runs),
              f"{label}: NaN at and past each tile's count is never read")
    return runs, got[2], got[3], err


def phase_kernel_parity(gen):
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print("phase 2: kernels against their plain versions", flush=True)
    ntx, nty = -(-W // 16), -(-H // 16)
    t = ntx * nty

    counts = torch.randint(0, 257, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    slabs = random_slabs(gen, t, 256, 4, counts, ntx)
    out, acc = rp.composite_tiles(*slabs, ntx)
    ro, ra = rp.composite_tiles_ref(*slabs, ntx)
    err = max(max_abs(out, ro), max_abs(acc, ra))
    print(f"  composite T={t} K=256 D=4: max_abs_err {err:.3e}")
    check(err <= TOL, f"composite K=256 within {TOL}")
    check_fwd(slabs, ntx, counts, 0, f"composite T={t} K=256 D=4, counted",
              poison=True)
    # counts well below K, and 0, 1, K and past K, at K = 256 and an odd K
    for k, d in ((256, 4), (333, 3)):
        low = torch.randint(0, 97, (t,), generator=gen, device="cuda",
                            dtype=torch.int32)
        low[:4] = torch.tensor([0, 1, k, k + 50], device="cuda",
                               dtype=torch.int32)
        slabs = random_slabs(gen, t, k, d, low, ntx)
        check_fwd(slabs, ntx, low, 0, f"composite T={t} K={k} D={d}, counts "
                  "below 97 (and 0, 1, K, past K)", poison=True)

    k = 2048
    slabs, counts = chunked_case(gen, t, 4, ntx, k)
    check_fwd(slabs, ntx, counts, rp.K_CHUNK, f"composite chunked T={t} "
              f"K={k} D=4, counted", poison=True)
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    out, acc = rp.composite_tiles_chunked(*slabs, ntx, tile_counts=counts,
                                          chunks_run=runs)
    ro, ra = rp.composite_tiles_ref(*slabs, ntx, tile_counts=counts,
                                    k_chunk=rp.K_CHUNK, chunks_run=runs_ref)
    err = max(max_abs(out, ro), max_abs(acc, ra))
    by_count = int(((runs < 2) & (counts <= rp.K_CHUNK)).sum())
    by_sat = int(((runs < 2) & (counts > rp.K_CHUNK)).sum())
    print(f"  composite chunked T={t} K={k}: max_abs_err {err:.3e}; tiles "
          f"skipping chunk 2: {by_count} by count, {by_sat} saturated")
    check(err <= TOL, f"chunked composite K=2048 within {TOL}")
    check(torch.equal(runs, runs_ref), "chunks run per tile equal the plain")
    check(by_count > 0 and by_sat > 0, "both skip reasons fired")

    m = 2_000_000
    keys = torch.sort(torch.randint(0, 1 << 40, (m,), generator=gen,
                                    device="cuda")).values
    starts = torch.sort(torch.randint(0, m, (t,), generator=gen,
                                      device="cuda")).values
    starts[:6] = torch.tensor([0, m, m + 5, -3, m - 7, 12345],
                              device="cuda")
    n_odd = int((starts & 1).sum())
    for k in (256, 1024, 2048, 333):
        counts = torch.randint(0, 2 * k, (t,), generator=gen, device="cuda",
                               dtype=torch.int32)
        counts[6:10] = torch.tensor([0, 1, k, k + 1], device="cuda",
                                    dtype=torch.int32)
        got = tiles.slab_gather(keys, starts, k, -1)
        want = tiles.slab_gather_ref(keys, starts, k, -1)
        check(torch.equal(got, want), f"slab_gather K={k} exact (starts 0, "
              f"M, past M, negative, M - 7; {n_odd} odd starts)")
        got = tiles.slab_ranks(keys, starts, counts, k, 18)
        want = tiles.slab_ranks_ref(keys, starts, counts, k, 18)
        check(torch.equal(got, want), f"slab_gather rank mode K={k} exact "
              "(counts 0, 1, K, past K)")
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 2b

def bwd_channel_errs(got, want):
    """[(max |kernel - plain| / max |plain|) for every output channel]."""
    errs = []
    for g, w in zip(got, want):
        for c in range(w.shape[1]):
            scale = max(float(w[:, c].abs().max()), 1e-30)
            errs.append(float((g[:, c] - w[:, c]).abs().max()) / scale)
    return errs


def check_bwd(got, want, runs, k_chunk, label, counts=None):
    errs = bwd_channel_errs(got, want)
    abs_err = max(max_abs(g, w) for g, w in zip(got, want))
    print(f"  {label}: per-channel max err / max |plain| "
          f"{', '.join(f'{e:.2e}' for e in errs)}; max_abs_err {abs_err:.3e}")
    check(max(errs) <= BWD_TOL, f"{label} within {BWD_TOL} of each "
          "channel's max")
    if k_chunk:
        k = got[0].shape[-1]
        slot = torch.arange(k, device="cuda")[None, None, :]
        past = slot >= (runs.long() * k_chunk)[:, None, None]
        check(all(not bool(torch.where(past, g, 0.0).any()) for g in got),
              f"{label}: exact zeros past each tile's composited chunks")
    if counts is not None:
        k = got[0].shape[-1]
        slot = torch.arange(k, device="cuda")[None, None, :]
        past = slot >= counts.long()[:, None, None]
        check(all(not bool(torch.where(past, g, 0.0).any()) for g in got),
              f"{label}: exact zeros at and past each tile's count")
    return abs_err


def phase_bwd_parity(gen):
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    print("phase 2b: backward kernel against its plain version", flush=True)
    ntx, nty = -(-W // 16), -(-H // 16)
    t = ntx * nty
    d = 4
    counts = torch.randint(0, 257, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    slabs = random_slabs(gen, t, 256, d, counts, ntx)
    gout = torch.randn((t, d, 256), generator=gen, device="cuda")
    gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
    # every backward below is fed by the forward kernel's own t_last and cut,
    # which check_fwd first holds to the plain version bit for bit
    runs, t_last, cut, _ = check_fwd(slabs, ntx, None, 0,
                                     f"composite T={t} K=256 D={d}")
    got = rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, 0, runs, None,
                                 t_last, cut)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx)
    check_bwd(got, want, runs, 0, f"composite_bwd T={t} K=256 D={d}")
    # tile counts well below K: the kernel stops at the count
    low = torch.randint(0, 97, (t,), generator=gen, device="cuda",
                        dtype=torch.int32)
    slabs = random_slabs(gen, t, 256, d, low, ntx)
    runs, t_last, cut, _ = check_fwd(slabs, ntx, low, 0, f"composite T={t} "
                                     f"K=256 D={d}, counts below 97")
    got = rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, 0, runs, low,
                                 t_last, cut)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx)
    check_bwd(got, want, runs, 0,
              f"composite_bwd T={t} K=256 D={d}, counts below 97", low)
    # 24-deep opaque stacks on every third tile: T falls to 1e-72
    deep = torch.zeros(t, dtype=torch.bool, device="cuda")
    deep[::3] = True
    full = torch.full((t,), 256, dtype=torch.int32, device="cuda")
    slabs = random_slabs(gen, t, 256, d, full, ntx, deep, depth=24)
    runs, t_last, cut, _ = check_fwd(slabs, ntx, None, 0, f"composite T={t} "
                                     f"K=256 D={d}, 24-deep opaque stacks")
    check(bool((cut[deep] < 256).all()) and bool((t_last >= rp.TRANS_MIN)
                                                 .all()),
          "under the stacks every pixel's cut lies inside the stack and "
          f"t_last >= {rp.TRANS_MIN:g}")
    got = rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, 0, runs, None,
                                 t_last, cut)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "gradients finite under 24-deep stacks")
    check_bwd(got, want, runs, 0,
              f"composite_bwd T={t} K=256 D={d}, 24-deep opaque stacks")

    k = 2048
    slabs, counts = chunked_case(gen, t, d, ntx, k)
    runs, t_last, cut, _ = check_fwd(slabs, ntx, counts, rp.K_CHUNK,
                                     f"composite chunked T={t} K={k} D={d}")
    by_count = int(((runs < 2) & (counts <= rp.K_CHUNK)).sum())
    by_sat = int(((runs < 2) & (counts > rp.K_CHUNK)).sum())
    both = int((runs == 2).sum())
    print(f"  chunked K={k}: {both} tiles composite both chunks; chunk 2 "
          f"skipped by {by_count} by count, {by_sat} saturated")
    check(both > 0 and by_count > 0 and by_sat > 0,
          "chunk 2 composited on some tiles and both skip reasons fired")
    got = rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, rp.K_CHUNK,
                                 runs, None, t_last, cut)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx,
                                      k_chunk=rp.K_CHUNK, chunks_run=runs)
    check_bwd(got, want, runs, rp.K_CHUNK,
              f"composite_bwd chunked T={t} K={k} D={d}")
    got = rp.composite_tiles_bwd(*slabs, gout, gacc, ntx, 16, rp.K_CHUNK,
                                 runs, counts, t_last, cut)
    check_bwd(got, want, runs, rp.K_CHUNK,
              f"composite_bwd chunked and counted T={t} K={k} D={d}", counts)
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 2c

def check_fwd_mixed(slabs, ntx, counts, k_chunk, label, poison=False):
    """The mixed forward kernel with its handoff against its plain version
    on the same slabs and counts: out and acc within TOL, the chunks run
    equal, and over the blocks and chunks each tile ran, the block sums of
    the rounded logs equal and the offsets (float32 sums in another order)
    and chunk transmittances within TOL relative. With ``poison`` also: NaN
    at and past each tile's count changes no output. Returns (chunks run,
    handoff, max abs err)."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, _, k = slabs[2].shape
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    out, acc, h = rp.composite_tiles_fwd_mixed(*slabs, ntx, 16, counts,
                                               k_chunk, runs, tail=True)
    ro, ra, hr = rp.composite_tiles_ref(*slabs, ntx, 16, counts, k_chunk,
                                        runs_ref, tail=True, mixed=True)
    err = max(max_abs(out, ro), max_abs(acc, ra))
    n_run = rp.slots_run(t, k, k_chunk, runs, counts, "cuda")
    nb, nc = rp.mixed_shapes(k, k_chunk)
    kc = k_chunk if 0 < k_chunk < k else k
    blk = (torch.arange(nb, device="cuda") * rp.MIX_BLOCK)[None] < n_run[:,
                                                                        None]
    chk = (torch.arange(nc, device="cuda") * kc)[None] < n_run[:, None]
    off, off_ref = h.offsets[blk], hr.offsets[blk]
    e_off = float(((off - off_ref).abs() / off_ref.abs().clamp(min=1.0))
                  .max()) if off.numel() else 0.0
    sums_equal = torch.equal(h.sums[blk], hr.sums[blk])
    e_tr = max_abs(h.trans[chk], hr.trans[chk])
    print(f"  {label}: max_abs_err {err:.3e}; handoff: offsets {e_off:.3e} "
          f"relative (bit-equal: {torch.equal(off, off_ref)}), chunk "
          f"transmittance {e_tr:.3e}")
    check(err <= TOL, f"{label} within {TOL}")
    check(torch.equal(runs, runs_ref), f"{label}: chunks run per tile equal "
          "the plain")
    check(sums_equal, f"{label}: the block sums of the rounded logs equal "
          "the plain version's")
    check(max(e_off, e_tr) <= TOL, f"{label}: block offsets and chunk "
          f"transmittances within {TOL}")
    if poison:
        slot = torch.arange(k, device="cuda")[None, None, :]
        past = slot >= counts[:, None, None]
        bad = [torch.where(past, float("nan"), x) for x in slabs[:3]]
        runs_p = torch.empty_like(runs)
        again = rp.composite_tiles_fwd_mixed(*bad, slabs[3], ntx, 16, counts,
                                             k_chunk, runs_p, tail=True)
        same = (torch.equal(again[0], out) and torch.equal(again[1], acc)
                and torch.equal(runs_p, runs)
                and all(torch.equal(x[m], y[m]) for x, y, m in (
                    (again[2].offsets, h.offsets, blk),
                    (again[2].sums, h.sums, blk),
                    (again[2].trans, h.trans, chk))))
        check(same, f"{label}: NaN at and past each tile's count is never "
              "read")
    return runs, h, err


def check_bwd_mixed(slabs, gout, gacc, ntx, k_chunk, runs, counts, handoff,
                    label):
    """The mixed backward kernel, fed by the mixed forward kernel's handoff,
    against autograd of the plain mixed forward (each bf16 rounding taken
    as the identity) within BWD_TOL of each channel's max."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    got = rp.composite_tiles_bwd_mixed(*slabs, gout, gacc, ntx, 16, k_chunk,
                                       runs, counts, handoff)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, 16,
                                      k_chunk=k_chunk, chunks_run=runs,
                                      tile_counts=counts, mixed=True)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{label}: gradients finite")
    return check_bwd(got, want, runs, k_chunk, label, counts)


def phase_mixed_parity(gen):
    """The mixed_precision kernels against their plain versions on random
    slabs: K = 256 (two 128-slot blocks) with counts, an odd K with counts
    of 0, 1, K and past K, 24-deep opaque stacks (E far below float32's
    exp range), and chunked at K = 2048."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    print("phase 2c: the mixed_precision kernels against their plain "
          "versions", flush=True)
    ntx, nty = -(-W // 16), -(-H // 16)
    t = ntx * nty
    cases = []
    counts = torch.randint(0, 257, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    cases.append(("K=256 D=4, counted", random_slabs(gen, t, 256, 4, counts,
                                                      ntx), counts, 0, True))
    low = torch.randint(0, 97, (t,), generator=gen, device="cuda",
                        dtype=torch.int32)
    low[:4] = torch.tensor([0, 1, 333, 383], device="cuda",
                           dtype=torch.int32)
    cases.append(("K=333 D=3, counts below 97 (and 0, 1, K, past K)",
                  random_slabs(gen, t, 333, 3, low, ntx), low, 0, True))
    deep = torch.zeros(t, dtype=torch.bool, device="cuda")
    deep[::3] = True
    full = torch.full((t,), 256, dtype=torch.int32, device="cuda")
    cases.append(("K=256 D=4, 24-deep opaque stacks",
                  random_slabs(gen, t, 256, 4, full, ntx, deep, depth=24),
                  full, 0, False))
    slabs, counts = chunked_case(gen, t, 4, ntx, 2048)
    cases.append(("chunked K=2048 D=4, counted", slabs, counts, rp.K_CHUNK,
                  True))
    errs = {}
    for label, slabs, counts, k_chunk, poison in cases:
        d = slabs[2].shape[1]
        runs, h, err = check_fwd_mixed(slabs, ntx, counts, k_chunk,
                                       f"composite mixed T={t} {label}",
                                       poison)
        if k_chunk:
            by_count = int(((runs < 2) & (counts <= rp.K_CHUNK)).sum())
            by_sat = int(((runs < 2) & (counts > rp.K_CHUNK)).sum())
            both = int((runs == 2).sum())
            print(f"  chunked: {both} tiles composite both chunks; chunk 2 "
                  f"skipped by {by_count} by count, {by_sat} saturated")
            check(both > 0 and by_count > 0 and by_sat > 0,
                  "chunk 2 composited on some tiles and both skip reasons "
                  "fired")
        gout = torch.randn((t, d, 256), generator=gen, device="cuda")
        gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
        err_b = check_bwd_mixed(slabs, gout, gacc, ntx, k_chunk, runs, counts,
                                h, f"composite_bwd mixed T={t} {label}")
        errs[label] = (err, err_b)
    torch.cuda.synchronize()
    return errs


# ------------------------------------------------------------ phases 3, 4

def make_scene(n_alive, capacity, seed):
    """The bench's synthetic scene, with random SH bands and opacities."""
    from qed_splatter_tpu_torch.models.gaussians import init_from_points

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n_alive, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.7 + 3.0
    rgb = (rng.uniform(0, 1, (n_alive, 3)) * 255).astype(np.uint8)
    params = init_from_points(pts, rgb, capacity=capacity, seed=seed,
                              device="cuda")
    rest = rng.normal(0, 0.1, tuple(params.features_rest.shape))
    opac = rng.uniform(-2.0, 3.0, (capacity,))
    return params.replace(
        features_rest=torch.as_tensor(rest.astype(np.float32), device="cuda"),
        opacities=torch.as_tensor(opac.astype(np.float32), device="cuda"),
    )


def cameras(n):
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl, \
        orbit_intrinsics

    K = orbit_intrinsics(W, H, 0.85)
    return [(orbit_c2w_opengl(3.0, 2 * math.pi * i / n, 0.15, (0, 0, 3.0)),
             K) for i in range(n)]


def needed_slots(counts, runs, k, k_chunk):
    """Slots this run's data needs composited: each tile's count, capped at
    K and at the chunks it ran."""
    needed = torch.minimum(torch.minimum(counts.long(), torch.tensor(
        k, device=counts.device)), runs.long() * (k_chunk or k))
    return int(needed.sum())


def entry(name, label, launches, err, ms, plain_ms, lib_ms, bound_b,
          bound_o):
    return {
        "name": f"{name} ({label})",
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "operations" if bound_o > bound_b else "bytes",
        "library_ms": lib_ms,
    }


class Capture:
    """Records the arguments of one call of a module function while still
    calling it, to time a kernel on the render's own inputs."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = self.kwargs = None

    def __enter__(self):
        def rec(*args, **kwargs):
            if self.args is None:
                self.args, self.kwargs = args, kwargs
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_scene(label, n_alive, capacity, k_cap, n_cams, reps, seed,
                profile_dir):
    import dataclasses

    from qed_splatter_tpu_torch.configs import ModelConfig
    from qed_splatter_tpu_torch.models.splatfacto import render
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase {label}: {n_alive} alive / {capacity} capacity, "
          f"K={k_cap}, {W}x{H}, {n_cams} cameras", flush=True)
    t0 = time.perf_counter()
    params = make_scene(n_alive, capacity, seed)
    torch.cuda.synchronize()
    print(f"  scene init {time.perf_counter() - t0:.2f} s")
    cfg = ModelConfig(max_per_tile=k_cap)
    cams = cameras(n_cams)

    # --- the main path: counts from 0, every camera once
    rp.COMPOSITE.reset()
    tiles.SLAB_GATHER.reset()
    outs = [render(params, c2w, K, W, H, cfg, step=30_000) for c2w, K in cams]
    torch.cuda.synchronize()
    launches = {"composite": rp.COMPOSITE.launches,
                "slab_gather": tiles.SLAB_GATHER.launches}
    chunked = rp.COMPOSITE.variant_launches.get("chunked", 0)
    ranked = tiles.SLAB_GATHER.variant_launches.get("ranks", 0)
    print(f"  launches {launches}, chunked composite launches {chunked}, "
          f"rank-mode slab_gather launches {ranked}")
    check(all(v >= n_cams for v in launches.values()),
          "every kernel launched on the main path")
    check(ranked >= n_cams, "the binning took the gather's fused rank mode")
    if k_cap > rp.K_CHUNK:
        check(chunked >= n_cams, "the compositor's chunked path ran")
    for o in outs:
        check(tuple(o.rgb.shape) == (H, W, 3)
              and tuple(o.depth.shape) == (H, W, 1)
              and tuple(o.accumulation.shape) == (H, W, 1),
              "output shapes")
        check(bool(torch.isfinite(o.rgb).all() & torch.isfinite(o.depth).all()
                   & torch.isfinite(o.accumulation).all()),
              "rgb, depth and alpha finite")
    o = outs[0]
    print(f"  frame 0: mean alpha {float(o.accumulation.mean()):.4f}, "
          f"tile_max_count {int(o.tile_max_count)}, tile_overflow "
          f"{int(o.tile_overflow)}, bbox_truncated {int(o.bbox_truncated)}")

    # --- one frame against the plain path on the card
    c2w, K = cams[0]
    plain = render(params, c2w, K, W, H,
                   dataclasses.replace(cfg, use_pallas=False), step=30_000)
    e_rgb = max_abs(o.rgb, plain.rgb)
    e_acc = max_abs(o.accumulation, plain.accumulation)
    e_dep = float(((o.depth - plain.depth).abs()
                   / plain.depth.abs().clamp(min=1.0)).max())
    print(f"  frame vs plain path: rgb {e_rgb:.3e}, alpha {e_acc:.3e}, "
          f"depth (relative) {e_dep:.3e}")
    check(max(e_rgb, e_acc, e_dep) <= TOL, f"frame matches plain within {TOL}")

    # --- the kernels on this frame's own inputs
    with Capture(rp, "composite_tiles_chunked") as cap_c, \
            Capture(tiles, "slab_ranks") as cap_g:
        render(params, c2w, K, W, H, cfg, step=30_000)
    torch.cuda.synchronize()
    g_args, g_kw = cap_c.args, cap_c.kwargs
    counts = g_kw["tile_counts"]
    t, d, k = g_args[2].shape
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    out, acc = rp.composite_tiles_chunked(*g_args, tile_counts=counts,
                                          chunks_run=runs)
    k_chunk = rp.K_CHUNK if k > rp.K_CHUNK else 0
    ro, ra = rp.composite_tiles_ref(*g_args, tile_counts=counts,
                                    k_chunk=k_chunk, chunks_run=runs_ref)
    err_c = max(max_abs(out[:, :3], ro[:, :3]), max_abs(acc, ra))
    err_d = float(((out[:, 3:] - ro[:, 3:]).abs()
                   / ro[:, 3:].abs().clamp(min=1.0)).max())
    err_abs = max(err_c, max_abs(out, ro))
    print(f"  composite on frame inputs: rgb/alpha {err_c:.3e}, depth "
          f"(relative) {err_d:.3e}, max_abs_err {err_abs:.3e}")
    check(max(err_c, err_d) <= TOL, f"composite on frame within {TOL}")
    check(torch.equal(runs, runs_ref), "chunks run per tile equal the plain")
    n_chunks = -(-k // rp.K_CHUNK)
    skipped = runs < n_chunks
    skip_count = int((skipped & (counts <= rp.K_CHUNK * (n_chunks - 1))).sum())
    skip_sat = int(skipped.sum()) - skip_count
    if k_chunk:
        print(f"  tiles that skipped a chunk: {int(skipped.sum())} of {t} "
              f"({skip_count} by count, {skip_sat} saturated)")

    keys, starts, g_counts, kk, rank_bits = cap_g.args
    fill = -1
    got = tiles.slab_ranks(keys, starts, g_counts, kk, rank_bits)
    want = tiles.slab_ranks_ref(keys, starts, g_counts, kk, rank_bits)
    check(torch.equal(got, want), "slab_gather rank mode on frame inputs "
          "exact")
    got = tiles.slab_gather(keys, starts, kk, fill)
    want = tiles.slab_gather_ref(keys, starts, kk, fill)
    check(torch.equal(got, want), "slab_gather on frame inputs exact")
    del got, want

    # --- times
    fr = []
    for _ in range(reps):
        for c2w_i, K_i in cams:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            render(params, c2w_i, K_i, W, H, cfg, step=30_000)
            torch.cuda.synchronize()
            fr.append((time.perf_counter() - t1) * 1e3)
    frame_ms = statistics.median(fr)
    print(f"  render: median {frame_ms:.3f} ms per frame over {len(fr)} "
          f"frames (min {min(fr):.3f}, max {max(fr):.3f})")

    # the kernel alone (replays of a captured graph), and the differentiable
    # entry point launched from the host, whose cost per call is of the
    # kernel's order
    ms_c = graph_ms(lambda: rp.composite_tiles_fwd(*g_args, counts, k_chunk),
                    20)
    host_c = cuda_ms(lambda: rp.composite_tiles_chunked(
        *g_args, tile_counts=counts), 20)
    plain_c = cuda_ms(lambda: rp.composite_tiles_ref(
        *g_args, tile_counts=counts, k_chunk=k_chunk), 2)
    in_bytes = sum(x.numel() * 4 for x in g_args[:4]) + counts.numel() * 4
    out_bytes = (out.numel() + acc.numel()) * 4
    ops = 256 * needed_slots(counts, runs, k, k_chunk) * fwd_ops_per_pair(d)
    b_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_F32_PER_S * 1e3

    # the gather runs for microseconds, less than a launch costs the host:
    # its times are the device's own (replays of a captured CUDA graph);
    # the host-issued times of the wrapper and the library call are printed
    m = keys.numel()
    padded = torch.cat([keys, torch.full((kk,), fill, dtype=keys.dtype,
                                         device="cuda")])
    windows = padded.unfold(0, kk, 1)              # a view, no copy
    st = starts.clamp(0, m)
    k_idx = torch.arange(kk, device="cuda")[None, :]
    cap_counts = g_counts.clamp(max=kk)[:, None]
    mask = (1 << rank_bits) - 1
    minus = torch.full((starts.numel(), kk), -1, dtype=torch.int64,
                       device="cuda")

    def lib_ranks():
        # one library gather, then the rank mask in three elementwise calls
        slabs = torch.index_select(windows, 0, st)
        return torch.where(k_idx < cap_counts, slabs & mask, minus)

    check(torch.equal(lib_ranks(), tiles.slab_ranks(
        keys, starts, g_counts, kk, rank_bits)), "the library form of the "
        "rank mode agrees")
    calls = {
        "gather": lambda: tiles.slab_gather(keys, starts, kk, fill),
        "gather_plain": lambda: tiles.slab_gather_ref(keys, starts, kk, fill),
        "gather_lib": lambda: torch.index_select(windows, 0, st),
        "ranks": lambda: tiles.slab_ranks(keys, starts, g_counts, kk,
                                          rank_bits),
        "ranks_plain": lambda: tiles.slab_ranks_ref(keys, starts, g_counts,
                                                    kk, rank_bits),
        "ranks_lib": lib_ranks,
    }
    host = {name: cuda_ms(fn, 50) for name, fn in calls.items()}
    before = tiles.SLAB_GATHER.launches
    dev = {name: graph_ms(fn, 20) for name, fn in calls.items()}
    check(tiles.SLAB_GATHER.launches > before, "the captured graphs hold "
          "the wrapper's own launches")
    ms_g, plain_g, lib_g = dev["gather"], dev["gather_plain"], dev["gather_lib"]
    ms_r, plain_r, lib_r = dev["ranks"], dev["ranks_plain"], dev["ranks_lib"]
    g_bytes = (m + starts.numel() + starts.numel() * kk) * 8
    # rank mode reads only the keys below each tile's count
    r_read = int(torch.minimum(g_counts.long().clamp(min=0, max=kk),
                               (m - st)).sum())
    r_bytes = (r_read + starts.numel() + starts.numel() * kk) * 8 \
        + g_counts.numel() * 4
    print(f"  composite {ms_c:.4f} ms ({host_c:.4f} ms launched from the "
          f"host through autograd; plain {plain_c:.3f} ms), bound "
          f"{max(b_bytes, b_ops):.4f} ms ({b_ops:.4f} by operations, "
          f"{b_bytes:.4f} by bytes), {ms_c / max(b_bytes, b_ops):.2f}x its "
          f"bound; {needed_slots(counts, runs, k, k_chunk)} of {t * k} slots "
          "needed")
    print(f"  slab_gather on the device: gather mode {ms_g:.4f} ms (plain "
          f"{plain_g:.4f}, index_select {lib_g:.4f} ms), rank mode "
          f"{ms_r:.4f} ms (plain {plain_r:.4f}, index_select and the mask "
          f"{lib_r:.4f} ms)")
    print("  slab_gather issued by the host, launch cost included: "
          + ", ".join(f"{name} {v:.4f}" for name, v in host.items()))
    del padded, windows, minus

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for c2w_i, K_i in cams:
                render(params, c2w_i, K_i, W, H, cfg, step=30_000)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        # device time = the GPU kernel and memcpy events themselves (one
        # stream, so they do not overlap); the aten rows would count it twice
        busy_ms = sum(e.self_device_time_total for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        path = f"{profile_dir}/profile_scene_{label}.txt"
        with open(path, "w") as f:
            f.write(table)
        print(f"  profile of {n_cams} frames written to {path}: device busy "
              f"{busy_ms / n_cams:.3f} ms per frame of {wall_ms / n_cams:.3f} "
              f"ms wall under the profiler (idle share "
              f"{1 - busy_ms / wall_ms:.3f})")

    label_k = f"scene {label}, K={k_cap}"
    entries = [
        entry("composite", label_k, launches["composite"], err_abs, ms_c,
              plain_c, None, b_bytes, b_ops),
        # one kernel, two modes: the row is the rank mode, which is every
        # launch of the main path (checked above); the gather mode, launched
        # here only to be held and timed, goes beside it
        entry("slab_gather", label_k + ", rank mode", launches["slab_gather"],
              0.0, ms_r, plain_r, lib_r, r_bytes / PEAK_BYTES_PER_S * 1e3,
              0.0),
    ]
    # ms is the kernel alone (graph replays); launched from the host through
    # its differentiable entry point, as earlier runs timed it:
    entries[0]["ms_launched_from_host"] = host_c
    entries[-1]["gather_mode"] = {
        "launches": launches["slab_gather"] - ranked, "max_abs_err": 0.0,
        "ms": ms_g, "plain_ms": plain_g, "library_ms": lib_g,
        "bound_ms": g_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del outs, plain, params
    torch.cuda.empty_cache()
    return entries, frame_ms


# ------------------------------------------------------------ train phases

def train_batch(rng):
    """``bench.py``'s batch: one orbit camera, uniform RGB, depth uniform in
    0.5-4.0, on the card."""
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl, \
        orbit_intrinsics

    return dict(
        c2w=torch.as_tensor(orbit_c2w_opengl(3.0, 0.15, 0.1, (0, 0, 3.0)),
                            device="cuda"),
        K=torch.as_tensor(orbit_intrinsics(W, H, 0.85), device="cuda"),
        cam_idx=0,
        rgb=torch.as_tensor(rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                            device="cuda"),
        depth=torch.as_tensor(
            rng.uniform(0.5, 4.0, (H, W, 1)).astype(np.float32),
            device="cuda"),
    )


KINKS = ("l1_sign", "clamp", "depth_sign", "alpha_zero")


@torch.no_grad()
def loss_branch_kinds(a, b, batch):
    """{kind: [H, W] bool}: the pixels where the loss takes another branch
    of one of its kinks on the frames ``a`` and ``b`` that two paths
    rendered of one state, by kind: the sign of the RGB L1 term (rgb - gt
    per channel), the clamp of rgb to [0, 1], the sign of the depth L1 term
    (depth - gt), and depth's fallback where alpha is 0. Frames that agree
    to rounding still fall on either side of a kink where a pixel lies
    within rounding of it, and there the two gradients differ by that
    pixel's whole weight."""
    rgb, depth = batch["rgb"], batch["depth"]
    clamp = torch.zeros_like(a.rgb[..., 0], dtype=torch.bool)
    for edge in (0.0, 1.0):
        clamp |= ((a.rgb == edge) != (b.rgb == edge)).any(-1)
    return {
        "l1_sign": (torch.sign(a.rgb - rgb)
                    != torch.sign(b.rgb - rgb)).any(-1),
        "clamp": clamp,
        "depth_sign": (torch.sign(a.depth - depth)
                       != torch.sign(b.depth - depth))[..., 0],
        "alpha_zero": ((a.accumulation > 0)
                       != (b.accumulation > 0))[..., 0],
    }


def loss_branch_pixels(a, b, batch):
    """[H, W] bool: the union of :func:`loss_branch_kinds`."""
    kinds = loss_branch_kinds(a, b, batch)
    differ = kinds["l1_sign"]
    for kind in KINKS[1:]:
        differ = differ | kinds[kind]
    return differ


@torch.no_grad()
def flipped_pairs(means, conics, opac, counts, num_tiles_x):
    """The (tile, pixel, slot) pairs on which the kernel path and the plain
    path (``use_pallas=False``) take another branch of alpha's
    discontinuities on the same slabs: kept or not (sigma >= 0 and
    op e^-sigma > 1/255), and capped at 0.999 or not. The kernels and their
    plain versions take the pixel offsets in tile-local coordinates,
    ``ops.rasterize`` in global ones, so a pair within rounding of a
    threshold can fall on either side. Both are evaluated here in plain
    PyTorch, op for op as the two modules do, over the slots below each
    tile's count. Returns (int64 [n, 3], op e^-sigma tile-local [n], global
    [n])."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops.rasterize import ALPHA_EPS, ALPHA_MAX

    t, _, k = means.shape
    pix = torch.arange(256, device=means.device)
    where, a_local, a_global = [], [], []
    group = max(1, (1 << 25) // (256 * k))
    for s in range(0, t, group):
        tid = torch.arange(s, min(s + group, t), device=means.device)
        m, c, o = (x[s:s + group] for x in (means, conics, opac))
        run = rp._slots_below(counts[s:s + group], k)
        a_loc, keep_loc = rp._alpha_local(m, c, o, tid, num_tiles_x, 16,
                                          run)[3:5]
        px = ((tid % num_tiles_x) * 16).float()[:, None] + (
            (pix % 16).float() + 0.5)[None, :]
        py = ((tid // num_tiles_x) * 16).float()[:, None] + (
            (pix // 16).float() + 0.5)[None, :]
        dx = m[:, None, 0, :] - px[:, :, None]
        dy = m[:, None, 1, :] - py[:, :, None]
        sigma = (0.5 * (c[:, None, 0, :] * dx * dx + c[:, None, 2, :] * dy * dy)
                 + c[:, None, 1, :] * dx * dy)
        a_glob = o[:, None, 0, :] * torch.exp(-sigma)
        keep_glob = (sigma >= 0.0) & (a_glob > ALPHA_EPS) & run[:, None, :]
        differ = (keep_loc != keep_glob) | (keep_loc & (
            (a_loc > ALPHA_MAX) != (a_glob > ALPHA_MAX)))
        idx = differ.nonzero()
        idx[:, 0] += s
        where.append(idx)
        a_local.append(a_loc[differ])
        a_global.append(a_glob[differ])
    return torch.cat(where), torch.cat(a_local), torch.cat(a_global)


def hold_grads(cfg, optims, width, height, at, a, batch, seed_bg, what, bar,
               max_kinks=None):
    """One step's gradients ``a`` at state ``at`` (kernel path) against the
    plain path (``use_pallas=False``) on the same batch and background seed,
    within ``bar`` of each tensor's max. The two frames agree to rounding,
    but a pixel that lies within rounding of a kink of the loss (rgb == gt
    in an L1 term, mostly) takes another branch on each path, and its whole
    weight shows in the difference (1e-4 to 2e-3 of a gradient's max, in
    about every second run of a trained state;
    ``tools/torch_step_grad_diff.py`` measures it). Such pixels are counted
    and, where there are any, masked out of the loss on both paths before
    the bar is held. ``max_kinks`` ({kind: most pixels}, see
    :func:`loss_branch_kinds`) bounds them by kind; by default 8 pixels in
    all. Returns the count of each kind."""
    import dataclasses

    from qed_splatter_tpu_torch.engine.train_step import make_train_step

    cfg_plain = dataclasses.replace(cfg, use_pallas=False)
    has_mask = "mask" in batch

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed_bg)

    def against_plain(a, steps, batch):
        b = steps[1].grads(at, batch, gen())
        torch.cuda.synchronize()
        rel = {}
        pairs = [*((g, a.params[g], b.params[g]) for g in a.params),
                 ("camera_opt", a.camera_opt, b.camera_opt),
                 ("absgrad", a.absgrad, b.absgrad)]
        for name, x, y in pairs:
            rel[name] = float((x - y).abs().max()) / max(
                float(y.abs().max()), 1e-30)
        e_loss = abs(float(a.loss) - float(b.loss)) / abs(float(b.loss))
        return rel, e_loss, b, (", ".join(
            f"{k} {v:.2e}" for k, v in rel.items())
            + f"; loss (relative) {e_loss:.2e}")

    steps = [make_train_step(c, optims, width, height, has_depth=True,
                             has_mask=has_mask) for c in (cfg, cfg_plain)]
    rel, e_loss, b, text = against_plain(a, steps, batch)
    kinds = loss_branch_kinds(a.out, b.out, batch)
    kinks = loss_branch_pixels(a.out, b.out, batch)
    n_kinks = int(kinks.sum())
    by_kind = {kind: int(kinds[kind].sum()) for kind in KINKS}
    print(f"  step gradients vs plain path {what} (max err / max |grad|): "
          f"{text}; pixels on another branch of the loss: {n_kinks}, by "
          f"kind {by_kind}")
    if max_kinks is None:
        check(n_kinks <= 8, "at most 8 pixels lie within rounding of a "
              "kink of the loss")
    else:
        check(all(by_kind[kind] <= most for kind, most in max_kinks.items()),
              f"pixels within rounding of a kink of the loss, by kind, at "
              f"most {max_kinks}")
    if n_kinks:
        keep = (~kinks)[..., None].float()
        masked = dict(batch, mask=keep * batch["mask"] if has_mask else keep)
        steps = [make_train_step(c, optims, width, height, has_depth=True,
                                 has_mask=True) for c in (cfg, cfg_plain)]
        a = steps[0].grads(at, masked, gen())
        rel, e_loss, b, text = against_plain(a, steps, masked)
        print(f"  the same with those {n_kinks} pixels masked out of the "
              f"loss: {text}")
        check(not bool((loss_branch_pixels(a.out, b.out, batch)
                        & ~kinks).any()), "no other pixel changed its branch")
    check(max(rel.values()) <= bar, f"every gradient {what} within {bar} of "
          "its max vs the plain path")
    check(e_loss <= TOL, f"loss within {TOL} relative of the plain path")
    return by_kind


def phase_train(label, n_alive, capacity, k_cap, n_warm, n_timed, seed,
                compare_plain, profile_dir):
    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    n_steps = n_warm + n_timed
    print(f"phase train {label}: {n_alive} alive / {capacity} capacity, "
          f"K={k_cap}, {W}x{H}, {n_warm} warm-up + {n_timed} timed steps",
          flush=True)
    t0 = time.perf_counter()
    params = make_scene(n_alive, capacity, seed)
    rng = np.random.default_rng(seed)
    batch = train_batch(rng)
    cfg = ModelConfig(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                      background_color="random")
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(params, optims, num_cameras=4)
    step = make_train_step(cfg, optims, W, H, has_depth=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    print(f"  scene and state init {time.perf_counter() - t0:.2f} s")

    # --- the main path: counts from 0, every step through make_train_step
    for kern in (rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.SLAB_GATHER):
        kern.reset()
    times, losses, nonfinite = [], [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
        nonfinite.append(float(metrics["nonfinite_grads"]))
    launches = {"composite": rp.COMPOSITE.launches,
                "composite_bwd": rp.COMPOSITE_BWD.launches,
                "slab_gather": tiles.SLAB_GATHER.launches}
    chunked_bwd = rp.COMPOSITE_BWD.variant_launches.get("chunked", 0)
    ranked = tiles.SLAB_GATHER.variant_launches.get("ranks", 0)
    print(f"  launches {launches}, chunked composite_bwd launches "
          f"{chunked_bwd}, rank-mode slab_gather launches {ranked}")
    check(all(v >= n_steps for v in launches.values()),
          f"every kernel launched at least once per step ({n_steps} steps)")
    check(launches["composite_bwd"] == n_steps
          and launches["slab_gather"] == n_steps == ranked,
          "one composite_bwd and one rank-mode slab_gather per step")
    if k_cap > rp.K_CHUNK:
        check(chunked_bwd >= n_steps, "the chunked backward ran")
    print(f"  loss per step: {', '.join(f'{x:.5f}' for x in losses)}")
    check(all(math.isfinite(x) for x in losses), "loss finite on every step")
    check(all(x == 0.0 for x in nonfinite), "nonfinite_grads == 0 on every "
          "step")
    check(all(bool(torch.isfinite(v).all()) for v in
              state.params.trainable_dict().values())
          and bool(torch.isfinite(state.camera_opt).all()),
          "parameters and camera deltas finite")
    print(f"  psnr {float(metrics['psnr']):.3f}, tile_max_count "
          f"{int(metrics['tile_max_count'])}, tile_overflow "
          f"{int(metrics['tile_overflow'])}, gaussian_count "
          f"{int(metrics['gaussian_count'])}")
    step_ms = statistics.median(times)
    print(f"  train step: median {step_ms:.3f} ms over {len(times)} steps "
          f"(min {min(times):.3f}, max {max(times):.3f})")

    # --- one step's gradients against the plain path, and the backward
    #     kernel on that step's own captured inputs
    seed_bg = seed + 17
    with Capture(rp, "composite_tiles_bwd") as cap, \
            Capture(rp, "composite_tiles_chunked") as cap_f:
        got = step.grads(state, batch,
                         torch.Generator(device="cuda").manual_seed(seed_bg))
    torch.cuda.synchronize()
    if compare_plain:
        def hold(at, a, what, bar):
            hold_grads(cfg, optims, W, H, at, a, batch, seed_bg, what, bar)

        hold(state, got, "after the steps", BWD_TOL)
        # and on a state made from the seed alone, the same from run to run:
        # the scene before any step, its scales spread (isotropic scales
        # give the rotations no gradient)
        fresh = make_scene(n_alive, capacity, seed)
        spread = np.random.default_rng(seed + 1).normal(
            0, 0.4, tuple(fresh.scales.shape)).astype(np.float32)
        fresh = init_train_state(fresh.replace(
            scales=fresh.scales + torch.as_tensor(spread, device="cuda")),
            optims, num_cameras=4)
        hold(fresh, step.grads(fresh, batch, torch.Generator(
            device="cuda").manual_seed(seed_bg)), "before any step",
            FRESH_TOL)
        del fresh

    args = cap.args
    slabs, gout, gacc = args[:4], args[4], args[5]
    ntx, ts, k_chunk, runs, counts, t_last, cut = args[6:13]
    check(counts is not None and counts.data_ptr()
          == cap_f.kwargs["tile_counts"].data_ptr(),
          "the step's backward was given the tile counts")
    t, d, k = slabs[2].shape
    # the handoff: what the step's forward gave its backward is what the
    # plain version carries over the slots the tile ran, bit for bit
    check(t_last is not None and cut is not None,
          "the step's forward handed its backward t_last and cut")
    with torch.no_grad():           # the step's own slabs require grad
        want_last, want_cut = rp.transmittance_tail_ref(
            slabs[0], slabs[1], slabs[3], ntx, ts,
            rp.slots_run(t, k, k_chunk, runs, counts, "cuda"))
    check(torch.equal(t_last, want_last) and torch.equal(cut, want_cut),
          "the step's t_last and cut equal the plain version bit for bit")
    del want_last, want_cut
    kern = rp.composite_tiles_bwd(*args)
    ref = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, ts,
                                     k_chunk=k_chunk, chunks_run=runs)
    err = check_bwd(kern, ref, runs, k_chunk,
                    f"composite_bwd on the step's slabs (T={t}, K={k})",
                    counts)
    del kern, ref
    ms = cuda_ms(lambda: rp.composite_tiles_bwd(*args), 20)
    # what the handoff costs the forward: the step's forward with and
    # without it, on the step's own slabs
    with torch.no_grad():
        ms_fwd = {tail: graph_ms(lambda: rp.composite_tiles_fwd(
            *slabs, ntx, ts, counts, k_chunk, None, tail), 20)
            for tail in (False, True)}
    plain_ms = cuda_ms(lambda: rp.composite_tiles_bwd_ref(
        *slabs, gout, gacc, ntx, ts, k_chunk=k_chunk, chunks_run=runs), 1)
    in_bytes = (sum(x.numel() for x in slabs) + gout.numel() + gacc.numel()
                + runs.numel() + counts.numel() + t_last.numel()
                + cut.numel()) * 4
    out_bytes = sum(x.numel() for x in slabs) * 4
    ops = 256 * needed_slots(counts, runs, k, k_chunk) * bwd_ops_per_pair(d)
    bound_b = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    bound_o = ops / PEAK_F32_PER_S * 1e3
    skipped = int((runs < -(-k // (k_chunk or k))).sum())
    print(f"  composite_bwd {ms:.4f} ms (plain {plain_ms:.3f} ms), bound "
          f"{max(bound_b, bound_o):.4f} ms ({bound_o:.4f} by operations, "
          f"{bound_b:.4f} by bytes), {ms / max(bound_b, bound_o):.2f}x its "
          f"bound; tiles with a skipped chunk {skipped} of {t}")
    print(f"  composite on the step's slabs: {ms_fwd[True]:.4f} ms with the "
          f"handoff to the backward, {ms_fwd[False]:.4f} ms without")

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(n_prof):
                state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        busy_ms = sum(e.self_device_time_total for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=50)
        path = f"{profile_dir}/profile_train_{label}.txt"
        with open(path, "w") as f:
            f.write(table)
        print(f"  profile of {n_prof} steps written to {path}: device busy "
              f"{busy_ms / n_prof:.3f} ms per step of {wall_ms / n_prof:.3f} "
              f"ms wall under the profiler (idle share "
              f"{1 - busy_ms / wall_ms:.3f})")

    entries = [entry("composite_bwd", f"train {label}, K={k_cap}",
                     launches["composite_bwd"], err, ms, plain_ms, None,
                     bound_b, bound_o)]
    entries[0]["forward_ms_with_handoff"] = ms_fwd[True]
    entries[0]["forward_ms_without_handoff"] = ms_fwd[False]
    del state, got, params, args, slabs, gout, gacc, t_last, cut
    torch.cuda.empty_cache()
    return entries, step_ms


def phase_train_mixed(label, n_alive, capacity, k_cap, n_steps, seed):
    """``mixed_precision`` training on a scene: ``n_steps`` steps of
    ``make_train_step`` through the bf16 operand kernels (the main path of
    the mixed kernels; chunked at K > K_CHUNK), one step's gradients against
    the float32 step's on the same state within the bf16 envelope
    (MIXED_TOL), and both mixed kernels held against their plain versions
    and timed on that step's own inputs."""
    import dataclasses

    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase train {label} mixed: {n_alive} alive / {capacity} "
          f"capacity, K={k_cap}, {W}x{H}, mixed_precision, {n_steps} steps",
          flush=True)
    params = make_scene(n_alive, capacity, seed)
    batch = train_batch(np.random.default_rng(seed))
    cfg = ModelConfig(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                      background_color="random", mixed_precision=True)
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(params, optims, num_cameras=4)
    step = make_train_step(cfg, optims, W, H, has_depth=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    chunked = k_cap > rp.K_CHUNK

    # --- the main path: counts from 0, every step through make_train_step
    kernels = {"composite": rp.COMPOSITE, "composite_bwd": rp.COMPOSITE_BWD,
               "composite_mixed": rp.COMPOSITE_MIXED,
               "composite_bwd_mixed": rp.COMPOSITE_BWD_MIXED,
               "slab_gather": tiles.SLAB_GATHER}
    for kern in kernels.values():
        kern.reset()
    times, losses = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {name: kern.launches for name, kern in kernels.items()}
    variants = {name: kernels[name].variant_launches.get("chunked", 0)
                for name in ("composite_mixed", "composite_bwd_mixed")}
    print(f"  launches {launches}, chunked {variants}; loss per step "
          f"{', '.join(f'{x:.5f}' for x in losses)}; step median "
          f"{statistics.median(times):.3f} ms")
    check(launches["composite_mixed"] == n_steps
          and launches["composite_bwd_mixed"] == n_steps
          and launches["slab_gather"] == n_steps,
          "one mixed composite, one mixed composite_bwd and one slab_gather "
          "per step")
    check(launches["composite"] == 0 and launches["composite_bwd"] == 0,
          "the mixed step launched no float32 compositing kernel")
    if chunked:
        check(all(v == n_steps for v in variants.values()),
              "the mixed kernels took their chunked path")
    check(all(math.isfinite(x) for x in losses)
          and float(metrics["nonfinite_grads"]) == 0.0,
          "loss finite and nonfinite_grads == 0 on every step")

    # --- one step's gradients against the float32 step's, on the scene
    #     before any step with its scales spread (isotropic scales give the
    #     rotations no gradient), the same state from run to run
    seed_bg = seed + 29

    def bg():
        return torch.Generator(device="cuda").manual_seed(seed_bg)

    del state
    fresh = make_scene(n_alive, capacity, seed)
    spread = np.random.default_rng(seed + 1).normal(
        0, 0.4, tuple(fresh.scales.shape)).astype(np.float32)
    state = init_train_state(fresh.replace(
        scales=fresh.scales + torch.as_tensor(spread, device="cuda")),
        optims, num_cameras=4)
    with Capture(rp, "composite_tiles_fwd_mixed") as cap_f, \
            Capture(rp, "composite_tiles_bwd_mixed") as cap_b:
        gm = step.grads(state, batch, bg())
    step32 = make_train_step(dataclasses.replace(cfg, mixed_precision=False),
                             optims, W, H, has_depth=True)
    g32 = step32.grads(state, batch, bg())
    torch.cuda.synchronize()
    pairs = [*((g, gm.params[g], g32.params[g]) for g in gm.params),
             ("camera_opt", gm.camera_opt, g32.camera_opt),
             ("absgrad", gm.absgrad, g32.absgrad)]
    rel = {name: float((x - y).abs().max()) / max(float(y.abs().max()),
                                                  1e-30)
           for name, x, y in pairs}
    e_loss = abs(float(gm.loss) - float(g32.loss)) / abs(float(g32.loss))
    e_rgb = max_abs(gm.out.rgb.detach(), g32.out.rgb.detach())
    print(f"  mixed step vs float32 step (max err / max |grad|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f"; loss (relative) {e_loss:.2e}; rgb max abs {e_rgb:.2e}")
    check(max(rel.values()) <= MIXED_TOL, f"every gradient within "
          f"{MIXED_TOL} of its max of the float32 step's (the bf16 envelope)")
    check(e_loss <= 1e-3, "loss within 1e-3 relative of the float32 step's")
    check(e_rgb > 0.0, "the bf16 roundings show in the frame")
    del g32, step32

    # --- both kernels on the step's own inputs
    fargs = cap_f.args
    slabs = [x.detach() for x in fargs[:4]]
    ntx, ts, counts, k_chunk = fargs[4:8]
    t, d, k = slabs[2].shape
    runs, h, err_f = check_fwd_mixed(slabs, ntx, counts, k_chunk,
                                     f"composite mixed on the step's slabs "
                                     f"(T={t}, K={k})")
    bargs = list(cap_b.args)
    gout, gacc = bargs[4], bargs[5]
    check(torch.equal(bargs[9], runs) and bargs[10] is not None,
          "the step's backward replayed the forward's chunks, with the "
          "tile counts")
    err_b = check_bwd_mixed(slabs, gout, gacc, ntx, k_chunk, runs, counts,
                            bargs[11], f"composite_bwd mixed on the step's "
                            f"slabs (T={t}, K={k})")
    ms_f = graph_ms(lambda: rp.composite_tiles_fwd_mixed(
        *slabs, ntx, ts, counts, k_chunk, None, True), 20)
    plain_f = cuda_ms(lambda: rp.composite_tiles_ref(
        *slabs, ntx, ts, counts, k_chunk, tail=True, mixed=True), 1)
    ms_b = cuda_ms(lambda: rp.composite_tiles_bwd_mixed(
        *slabs, gout, gacc, ntx, ts, k_chunk, runs, counts, h), 20)
    plain_b = cuda_ms(lambda: rp.composite_tiles_bwd_ref(
        *slabs, gout, gacc, ntx, ts, k_chunk=k_chunk, chunks_run=runs,
        tile_counts=counts, mixed=True), 1)
    needed = needed_slots(counts, runs, k, k_chunk)
    nb, nc = rp.mixed_shapes(k, k_chunk)
    slab_bytes = sum(x.numel() for x in slabs) * 4
    hand_bytes = t * 256 * (2 * nb + nc) * 4
    f_bytes = slab_bytes + counts.numel() * 4 + t * 256 * (d + 1) * 4 \
        + hand_bytes
    f_ops = 256 * needed * fwd_mixed_ops_per_pair(d)
    b_bytes = 2 * slab_bytes + t * 256 * (d + 1) * 4 + hand_bytes \
        + (runs.numel() + counts.numel()) * 4
    b_ops = 256 * needed * bwd_mixed_ops_per_pair(d)
    bounds = {}
    for name, ms, plain, nbytes, ops in (
            ("composite_mixed", ms_f, plain_f, f_bytes, f_ops),
            ("composite_bwd_mixed", ms_b, plain_b, b_bytes, b_ops)):
        bb = nbytes / PEAK_BYTES_PER_S * 1e3
        bo = ops / PEAK_F32_PER_S * 1e3
        bounds[name] = (bb, bo)
        print(f"  {name} {ms:.4f} ms (plain {plain:.3f} ms), bound "
              f"{max(bb, bo):.4f} ms ({bo:.4f} by operations, {bb:.4f} by "
              f"bytes), {ms / max(bb, bo):.2f}x its bound; {needed} of "
              f"{t * k} slots needed")
    suffix = "_chunked" if chunked else ""
    entries = [
        entry(f"composite_mixed{suffix}", f"train {label}, K={k_cap}",
              launches["composite_mixed"], err_f, ms_f, plain_f, None,
              *bounds["composite_mixed"]),
        entry(f"composite_bwd_mixed{suffix}", f"train {label}, K={k_cap}",
              launches["composite_bwd_mixed"], err_b, ms_b, plain_b, None,
              *bounds["composite_bwd_mixed"]),
    ]
    entries[0]["vs_float32_step"] = {"grad_rel_max": max(rel.values()),
                                     "loss_rel": e_loss}
    del state, gm, params, fresh, slabs, fargs, bargs, gout, gacc, h
    torch.cuda.empty_cache()
    return entries, statistics.median(times)


# ------------------------------------------------------------ bench phase

def phase_bench(seed):
    """``qed_splatter_tpu_torch.bench``'s three points (``bench.py``'s),
    shortened to BENCH_TIMED warm-up and timed steps (BENCH_DENSE_TIMED at
    the dense point): the bench line, and the mixed kernels' launches on
    the bench's mixed point."""
    from qed_splatter_tpu_torch import bench
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    print(f"phase bench: bench.py's three points, {BENCH_TIMED} warm-up + "
          f"{BENCH_TIMED} timed steps ({BENCH_DENSE_TIMED} at the dense "
          "point)", flush=True)
    mixed = (rp.COMPOSITE_MIXED, rp.COMPOSITE_BWD_MIXED)
    for kern in mixed:
        kern.reset()
    t0 = time.perf_counter()
    line = bench.run("cuda", seed, n_timed=BENCH_TIMED,
                     dense_n_timed=BENCH_DENSE_TIMED)
    wall = time.perf_counter() - t0
    print(json.dumps(line))
    steps = 2 * BENCH_TIMED + 1
    print(f"  {wall:.2f} s; mixed launches {[k.launches for k in mixed]} "
          f"(the mixed point's {steps} steps)")
    check(set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
          and line["value"] > 0 and line["extra"]["loss_finite"],
          "the bench line has bench.py's keys, a rate and finite losses")
    check(all(k.launches == steps for k in mixed), "the bench's mixed point "
          "went through the mixed kernels")
    return line


# ------------------------------------------------------------ tools phase

def phase_tools():
    """The two ported microbenchmarks (``qed_splatter_tpu_torch.tools``),
    the main path of kernels #6 (the window gather on 4-byte keys) and #7
    (the identity copy): each tool's run with the counts from 0, then each
    kernel held bit-equal against its plain version and the library call at
    the tool's shapes; times are the tool's own."""
    from qed_splatter_tpu_torch.ops import copy_rows as cr
    from qed_splatter_tpu_torch.ops import tiles
    from qed_splatter_tpu_torch.tools import bench_gather, bench_gather3

    print("phase tools: tools/bench_gather.py and bench_gather3.py ported",
          flush=True)
    tiles.SLAB_GATHER32.reset()
    cr.COPY_ROWS.reset()
    t6 = bench_gather.run("cuda", log=lambda x: print(f"  {x}", flush=True))
    l6 = tiles.SLAB_GATHER32.launches
    t7 = bench_gather3.run("cuda", log=lambda x: print(f"  {x}", flush=True))
    l7 = cr.COPY_ROWS.launches
    print(json.dumps({"bench_gather": t6, "bench_gather3": t7}))
    print(f"  launches: slab_gather i32 {l6}, copy_rows {l7}")
    check(l6 > 0 and l7 > 0, "each tool launched its kernel")
    check(not any(name.endswith(":eager") for name in (*t6, *t7)),
          "every formulation was timed by CUDA graph replays")

    pairs, starts = bench_gather.slab_case("cuda")
    k = bench_gather.K_CAP
    got = tiles.slab_gather(pairs, starts, k, 0)
    check(torch.equal(got, tiles.slab_gather_ref(pairs, starts, k, 0))
          and torch.equal(got, bench_gather.slab_library(pairs, starts, k)),
          f"slab_gather on 4-byte keys (T={starts.numel()}, K={k}, "
          f"M={pairs.numel()}) bit-equal to its plain version and "
          "index_select on an unfold view")
    # bytes: the keys the windows cover, once; the starts; the windows out
    m = pairs.numel()
    covered = torch.zeros(m + 1, dtype=torch.int32, device="cuda")
    st = starts.clamp(0, m)
    covered.index_add_(0, st, torch.ones_like(st, dtype=torch.int32))
    covered.index_add_(0, (st + k).clamp(max=m),
                       -torch.ones_like(st, dtype=torch.int32))
    read = int((covered.cumsum(0)[:m] > 0).sum())
    b6 = (read * 4 + starts.numel() * 8 + starts.numel() * k * 4) \
        / PEAK_BYTES_PER_S * 1e3
    entries = [entry("slab_gather_i32", "tools/bench_gather, slab_pallas_dma",
                     l6, 0.0, t6["slab_pallas_dma"],
                     t6["slab_pallas_dma_plain"],
                     t6["slab_pallas_dma_library"], b6, 0.0)]
    print(f"  slab_gather i32 {t6['slab_pallas_dma']:.4f} ms (plain "
          f"{t6['slab_pallas_dma_plain']:.4f}, library "
          f"{t6['slab_pallas_dma_library']:.4f}), bound {b6:.4f} ms by "
          f"bytes ({read} of {m} keys covered)")

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for label, n in (("327k", bench_gather3.N_TAB),
                     ("4p4M", bench_gather3.M_IDX)):
        x = torch.rand((n, bench_gather3.C), generator=gen, device="cuda")
        y = cr.copy_rows(x)
        check(torch.equal(y, cr.copy_rows_ref(x)) and y.data_ptr()
              != x.data_ptr(), f"copy_rows [{n}, {bench_gather3.C}] "
              "bit-equal to its plain version")
        b7 = 2 * x.numel() * 4 / PEAK_BYTES_PER_S * 1e3
        rows[label] = (t7[f"copy_{label}"], t7[f"copy_{label}_plain"],
                       t7[f"copy_{label}_library"], b7)
        print(f"  copy_rows {label}: {rows[label][0]:.4f} ms (plain "
              f"{rows[label][1]:.4f}, Tensor.copy_ {rows[label][2]:.4f}), "
              f"bound {b7:.4f} ms by bytes")
        del x, y
    ms, plain, lib, b7 = rows["4p4M"]
    entries.append(entry("copy_rows", "tools/bench_gather3, [4396032, 10]",
                         l7, 0.0, ms, plain, lib, b7, 0.0))
    ms, plain, lib, b7 = rows["327k"]
    entries[-1]["at_327680_rows"] = {"ms": ms, "plain_ms": plain,
                                     "library_ms": lib, "bound_ms": b7}
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------- trainer phase

TRAINER_FRAMES, TRAINER_POINTS = 14, 40_000
TRAINER_STEPS, TRAINER_RESUME = 400, 20
# the plain path's autograd keeps [tiles, 256, K] intermediates per saved
# tensor: its gradient check runs at the trained K, capped here
PLAIN_K_MAX = 1024
# pixels of the trained state on another branch of a kink of the loss, by
# kind (loss_branch_kinds). A trained state renders many pixels within
# rounding of their ground truth, in colour (8-bit) and in depth (mm), so
# either L1 term's sign may differ on up to one pixel in 10,000 (the readings
# were 29 and 25 of 1,088,640 with no alpha mask flipping between the
# paths); alpha > 0 differs only where a mask flips, which none may; the
# clamp at 0/1 read 0.
TRAINED_MAX_KINKS = {"l1_sign": W * H // 10_000, "clamp": 8,
                     "depth_sign": W * H // 10_000, "alpha_zero": 0}


def trainer_config(root, out, seed, profile_dir=None):
    """The trainer phase's run: the room at 1296x840, half resolution for
    200 steps, refine every 50 after a warm-up of 100, an opacity reset at
    step 250, a capacity that must grow at the first refine, K from 256
    with adaptive K on, a checkpoint every 200 steps, and ``profile_dir``'s
    trace of steps 10-14 of each ``train`` call."""
    from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
        TrainerConfig

    model = ModelConfig(num_downscales=1, resolution_schedule=200,
                        warmup_length=100, refine_every=50,
                        reset_alpha_every=4, init_capacity_headroom=1.05,
                        max_per_tile=256)
    return TrainerConfig(max_num_iterations=TRAINER_STEPS,
                         steps_per_eval_image=100,
                         steps_per_eval_all_images=0, steps_per_save=200,
                         log_every=10, output_dir=out,
                         data=DataConfig(data=root), model=model, seed=seed,
                         steps_per_dispatch=1, profile_dir=profile_dir)


def synced_ms(fn, into):
    """``fn`` with each call's synchronized wall time appended to ``into``."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t1) * 1e3)
        return out
    return run


def timed_steps(trainer, record):
    """Wrap the trainer's step functions, refine (with the opacity reset)
    and growth check: each call is timed (synchronized), steps by their
    width, and each step's loss kept."""
    trainer._refine = synced_ms(trainer._refine, record["refine_ms"])
    trainer._maybe_grow = synced_ms(trainer._maybe_grow, record["grow_ms"])
    orig = trainer._get_step_fn

    def get(width, *args, **kwargs):
        fn = orig(width, *args, **kwargs)
        timed = synced_ms(fn, record["ms"].setdefault(width, []))

        def run(state, batch, gen):
            out = timed(state, batch, gen)
            record["loss"].append(float(out[1]["loss"]))
            return out
        return run
    trainer._get_step_fn = get


def metrics_rows(run_dir, split):
    with open(run_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["split"] == split]


def same_state(a, b):
    """Every tensor of two TrainStates equal (``torch.equal``), and the
    step."""
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt

    flat = []

    def walk(x, y):
        if isinstance(x, dict):
            flat.append(x.keys() == y.keys())
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, torch.Tensor):
            flat.append(x.dtype == y.dtype and torch.equal(x, y))
        else:
            flat.append(x == y)
    walk(ckpt.state_to_dict(a), ckpt.state_to_dict(b))
    return all(flat)


def phase_trainer(seed, profile_dir):
    import dataclasses
    import tempfile
    from pathlib import Path

    from qed_splatter_tpu_torch import testing
    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.train_step import make_train_step
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase trainer: room dataset {W}x{H}, {TRAINER_FRAMES} frames, "
          f"{TRAINER_POINTS} seed points, {TRAINER_STEPS} steps + a resume "
          f"of {TRAINER_RESUME}", flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "room"
        t0 = time.perf_counter()
        testing.write_room_dataset(root, num_frames=TRAINER_FRAMES, width=W,
                                   height=H, sparse_ply=TRAINER_POINTS,
                                   workers=min(8, os.cpu_count() or 1))
        t_data = time.perf_counter() - t0
        trace_dir = Path(tmp) / "trace"
        cfg = trainer_config(str(root), str(Path(tmp) / "out"), seed,
                             str(trace_dir))
        t0 = time.perf_counter()
        dm = FullImageDatamanager(cfg.data, seed=seed)
        trainer = Trainer(cfg, datamanager=dm)
        for i in dm.scene.train_indices:
            dm.get_item(int(i))
        print(f"  dataset written in {t_data:.2f} s, parsed and decoded in "
              f"{time.perf_counter() - t0:.2f} s: {dm.num_train} train / "
              f"{dm.num_eval} eval views, {int(trainer.state.params.num_alive())}"
              f" gaussians in capacity {trainer.state.params.capacity}")
        first = trainer.eval_all(0)
        record = {"ms": {}, "loss": [], "refine_ms": [], "grow_ms": []}
        timed_steps(trainer, record)

        # --- the main path: counts from 0, the trainer's loop
        kernels = (rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.SLAB_GATHER)
        for kern in kernels:
            kern.reset()
        t0 = time.perf_counter()
        trainer.train(max_steps=TRAINER_STEPS // 2, finalize=False)
        mid = ckpt.copy_state(trainer.state, "cpu")
        trainer.train(max_steps=TRAINER_STEPS, finalize=False)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {"composite": rp.COMPOSITE.launches,
                    "composite_bwd": rp.COMPOSITE_BWD.launches,
                    "slab_gather": tiles.SLAB_GATHER.launches}
        variants = {"composite chunked": rp.COMPOSITE.variant_launches.get(
            "chunked", 0), "composite_bwd chunked":
            rp.COMPOSITE_BWD.variant_launches.get("chunked", 0),
            "slab_gather ranks": tiles.SLAB_GATHER.variant_launches.get(
                "ranks", 0)}
        print(f"  {TRAINER_STEPS} steps in {t_train:.2f} s with their "
              f"refines, evals and checkpoints; launches {launches}, "
              f"{variants}")
        check(all(v > 0 for v in launches.values()),
              "every kernel launched in the trainer's run")
        # profile_dir: a trace of steps 10-14 of each train call
        for at in (10, TRAINER_STEPS // 2 + 10):
            name = f"steps_{at}-{at + 4}"
            events = json.loads((trace_dir / f"trace_{name}.json")
                                .read_text())["traceEvents"]
            # "void (anonymous namespace)::composite_kernel<4, true>(...)"
            kern = {m.group(0) for e in events if e.get("cat") == "kernel"
                    for m in [re.search(r"composite\w*_kernel<[^>]*>",
                                        e["name"])] if m}
            table = (trace_dir / f"key_averages_{name}.txt").read_text()
            print(f"  profile_dir trace of {name}: {len(events)} events, "
                  f"compositing kernels {sorted(kern)}; key_averages "
                  f"{len(table.splitlines())} lines")
            check(any(k.startswith("composite_kernel") for k in kern)
                  and any(k.startswith("composite_bwd_kernel")
                          for k in kern),
                  f"the trace of {name} names composite and composite_bwd")
        for width, ms in sorted(record["ms"].items()):
            print(f"  bucket {width} px wide: {len(ms)} steps, median "
                  f"{statistics.median(ms):.3f} ms per step (min "
                  f"{min(ms):.3f}, max {max(ms):.3f})")
        full = record["ms"].get(W, [])
        check(len(full) >= 150, f"{len(full)} >= 150 steps at {W}x{H}")
        check(all(math.isfinite(x) for x in record["loss"])
              and len(record["loss"]) == TRAINER_STEPS,
              f"all {TRAINER_STEPS} losses finite")
        refines = metrics_rows(trainer.run_dir, "refine")
        # one growth check and one refine per cadence, in that order
        for r, ms_r, ms_g in zip(refines, record["refine_ms"],
                                 record["grow_ms"]):
            print(f"  refine at {r['step']}: alive {r['n_alive']:.0f}, "
                  f"culled {r['n_culled']:.0f}, split {r['n_split']:.0f}, "
                  f"dup {r['n_dup']:.0f}, added {r['n_added']:.0f}, "
                  f"dropped {r['n_dropped']:.0f}; refine and reset "
                  f"{ms_r:.2f} ms, growth check {ms_g:.2f} ms")
        check(any(r["n_added"] > 0 for r in refines),
              "a refine added gaussians")
        grows = metrics_rows(trainer.run_dir, "grow")
        for r in grows:
            print(f"  growth at {r['step']}: capacity "
                  f"{r['capacity_before']:.0f} -> {r['capacity_after']:.0f}")
        check(len(grows) >= 1, "the capacity grew")
        print(f"  K per bucket {trainer._k_by_d}, pair budget per bucket "
              f"{trainer._tpg_by_d}")
        final = trainer.eval_all(TRAINER_STEPS)
        for label, e in (("first", first), ("last", final)):
            print(f"  eval_all ({label}): psnr {e['rgb_psnr']:.3f}, ssim "
                  f"{e['rgb_ssim']:.4f}, depth abs_rel "
                  f"{e['depth_abs_rel']:.4f}, a1 {e['depth_a1']:.4f}, "
                  f"gaussians {e['gaussian_count']}")
        check(final["rgb_psnr"] > first["rgb_psnr"], "eval PSNR rose")
        t0 = time.perf_counter()
        trainer.finalize()
        meta = ckpt.checkpoint_meta(trainer.run_dir / "ckpts")
        print(f"  finalize {time.perf_counter() - t0:.2f} s; splat.ply "
              f"{(trainer.run_dir / 'splat.ply').stat().st_size} bytes")
        check(meta["tpg_by_d"] is not None and meta["k_by_d"] is not None,
              "the final checkpoint holds k_by_d and tpg_by_d")

        # --- one step's gradients on the trained state, kernel vs plain
        item = dm.get_item(int(dm.train_indices[0]))
        batch = trainer._prepare_batch(item, 1)[0]
        k_check = min(trainer.cfg.max_per_tile, PLAIN_K_MAX)
        cfg_check = dataclasses.replace(trainer.cfg, max_per_tile=k_check)
        step = make_train_step(cfg_check, trainer.optims, W, H,
                               has_depth=True)
        seed_bg = seed + 23
        with Capture(rp, "composite_tiles_chunked") as cap_c:
            got = step.grads(trainer.state, batch, torch.Generator(
                device="cuda").manual_seed(seed_bg))
        # a kink pixel is either an alpha mask that flips between the paths
        # (a kernel/plain divergence) or a pixel within rounding of a kink
        # of the loss: count the flips first
        c_args = cap_c.args
        flips, a_loc, a_glob = flipped_pairs(
            c_args[0].detach(), c_args[1].detach(), c_args[3].detach(),
            cap_c.kwargs["tile_counts"], c_args[4])
        print(f"  (tile, pixel, slot) pairs of the trained state whose alpha "
              f"mask flips between the kernel path and the plain path: "
              f"{flips.shape[0]}"
              + "".join(f"; {p} op e^-sigma * 255 {x * 255:.7f} (tile-local)"
                        f" / {y * 255:.7f} (global)" for p, x, y in zip(
                            flips.tolist()[:4], a_loc.tolist(),
                            a_glob.tolist())))
        kinks = hold_grads(cfg_check, trainer.optims, W, H, trainer.state,
                           got, batch, seed_bg,
                           f"on the trained state (K={k_check})", BWD_TOL,
                           max_kinks=TRAINED_MAX_KINKS)
        check(flips.shape[0] == 0, "no alpha mask flips between the kernel "
              "path and the plain path on the trained state")
        del got, step, c_args, cap_c

        # --- resume from the mid checkpoint
        mid_dir = trainer.run_dir / "ckpts" / f"step-{TRAINER_STEPS // 2:09d}"
        resumed = Trainer(dataclasses.replace(cfg, load_dir=str(mid_dir),
                                              profile_dir=None),
                          datamanager=dm, optims=trainer.optims)
        check(same_state(resumed.state, mid), "the resumed state equals "
              f"the one saved at step {mid.step}, tensor for tensor")
        saved = ckpt.checkpoint_meta(mid_dir)["tpg_by_d"]
        check(resumed._tpg_by_d == {int(d): k for d, k in saved.items()},
              "the resume restored the pair budget table")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                resumed.train(max_steps=mid.step + TRAINER_RESUME,
                              finalize=False)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t1) * 1e3
            busy_ms = sum(e.self_device_time_total for e in prof.events()
                          if e.device_type
                          == torch.autograd.DeviceType.CUDA) / 1e3
            path = f"{profile_dir}/profile_trainer.txt"
            with open(path, "w") as f:
                f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                                  row_limit=50))
            print(f"  profile of the {TRAINER_RESUME} resumed steps at "
                  f"{W}x{H} written to {path}: device busy "
                  f"{busy_ms / TRAINER_RESUME:.3f} ms per step of "
                  f"{wall_ms / TRAINER_RESUME:.3f} ms wall under the profiler"
                  f" (idle share {1 - busy_ms / wall_ms:.3f})")
        else:
            resumed.train(max_steps=mid.step + TRAINER_RESUME,
                          finalize=False)
        check(resumed.state.step == mid.step + TRAINER_RESUME
              and all(bool(torch.isfinite(v).all()) for v in
                      resumed.state.params.trainable_dict().values()),
              f"{TRAINER_RESUME} steps after the resume, params finite")
        del trainer, resumed, mid
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  trainer phase wall time {wall:.2f} s")
    return {"ms_per_step": {str(w): statistics.median(v)
                            for w, v in record["ms"].items()},
            "eval_psnr": [first["rgb_psnr"], final["rgb_psnr"]],
            "refine_ms": record["refine_ms"], "grow_check_ms": record[
                "grow_ms"], "launches": launches, "wall_s": wall,
            "trained_state_kinks": kinks, "alpha_mask_flips": 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler tables of each scene "
                         "and train phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

    from qed_splatter_tpu_torch import cuda as qcuda

    print("phase 1: build", flush=True)
    secs = qcuda.build(qcuda.sources())
    print(f"  built {qcuda.sources()} in {secs:.2f} s")
    for name, log in qcuda.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled name holds the template arguments (ILi4ELb0EE)
                print(f"  {name}: {line.strip().split('Compiling ')[-1]}")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"  card: {smi}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernel_parity(gen)
    phase_bwd_parity(gen)
    phase_mixed_parity(gen)
    kernels, frames, steps = [], {}, {}
    for label, n_alive, cap, k_cap, n_cams, reps in (
        ("A", 80_000, 131_072, 256, 4, 2),
        ("B", 288_000, 327_680, 2048, 2, 2),
    ):
        entries, frame_ms = phase_scene(label, n_alive, cap, k_cap, n_cams,
                                        reps, args.seed, args.profile)
        kernels += entries
        frames[label] = frame_ms
    for label, n_alive, cap, k_cap, n_warm, n_timed, compare in (
        ("A", 80_000, 131_072, 256, TRAIN_STEPS_WARM, TRAIN_STEPS_TIMED,
         True),
        ("B", 288_000, 327_680, 2048, 1, 2, False),
    ):
        entries, step_ms = phase_train(label, n_alive, cap, k_cap, n_warm,
                                          n_timed, args.seed, compare,
                                          args.profile)
        kernels += entries
        steps[label] = step_ms
    for label, n_alive, cap, k_cap, n_steps in (
        ("A", 80_000, 131_072, 256, 3),
        ("B", 288_000, 327_680, 2048, 2),
    ):
        entries, step_ms = phase_train_mixed(label, n_alive, cap, k_cap,
                                             n_steps, args.seed)
        kernels += entries
        steps[f"{label} mixed"] = step_ms
    bench_line = phase_bench(args.seed)
    kernels += phase_tools()

    trainer = phase_trainer(args.seed, args.profile)
    print(json.dumps({"render_ms_per_frame": frames,
                      "train_ms_per_step": steps, "bench": bench_line,
                      "trainer": trainer}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
