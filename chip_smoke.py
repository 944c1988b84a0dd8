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
   window gather at K = 256, 1024, 2048 and an odd K;
2b. hold the compositing backward kernel, fed by the forward kernel's
   transmittance, against its plain version on random slabs and cotangents,
   unchunked (K = 256) and chunked (K = 2048, chunk 2 composited on some
   tiles, both skip reasons firing), each also with tile counts well below K
   (exact zeros past the count), and under 24-deep opaque stacks, where the
   transmittance falls below float32;
2c. hold the mixed_precision (bf16 operand) kernels against their
   plain versions on random slabs: K = 256 (two 128-slot blocks) with
   counts, K = 333 with counts of 0, 1, K and past K, 24-deep opaque stacks,
   chunked at K = 2048, and an opaque block (128 slots of alpha 0.999,
   whose sum of rounded logs passes 2^24 units of 2^-15) alone at K = 256
   and inside chunk 2 at K = 2048; the forward's handoff (block offsets and
   sums of the rounded logs, chunk transmittances) feeds the backward; both
   kernels are also held bit-equal to their witness build, which takes the
   intrinsics (logf, __float2int_rn, __int2float_rn, __float2bfloat16_rn)
   in place of ``csrc/mixed.cuh``'s exact forms;
binning. the binning's kernel set (``csrc/binning.cu``: count, scan,
   place, emit) at the three benchmark cells' shapes (960x540 at K = 4096,
   1296x840 at K = 2048 and 1024; 1,000,000 alive rows of 2,097,152, pair
   budget 64): every output integer-equal to the plain path, one launch of
   each kernel a frame, the kernels' time (graph replays) and each one's
   (``torch.profiler``) beside their bound (the rows read once and the
   [T, K] ranks written once, at 3.35 TB/s), the plain path's time and the
   pairs a frame;
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
   both mixed kernels held and timed on that step's inputs, the shares of
   the mixed forward's and backward's work their warp culls leave out, and
   the share that lies behind T = 0 (which the backward does not skip),
   computed from that step's slabs in plain torch;
bench. ``python -m qed_splatter_tpu_torch.bench``'s three points
   (``bench.py``'s: 80k / K = 256, 288k / K = 1024, and 80k / K = 256 with
   ``mixed_precision``), shortened to 3 + 3 steps (2 + 2 at the dense
   point); prints the bench line;
tools. the ported microbenchmarks ``tools/bench_gather.py`` (the window
   gather on 4-byte keys, kernel #6) and ``tools/bench_gather3.py`` (the
   identity copy, kernel #7), each kernel bit-equal to its plain version,
   with the path the copy took at each shape (TMA bulk copies);
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
dispatch. multi-step dispatch (``engine/scan_runner.py``): (a) one chunk as
   a CUDA graph of the step against the per-step loop from one state, perm
   and backgrounds, on scene A (10 steps), scene B at K=2048 (4, the
   chunked kernels) and scene A with ``mixed_precision`` (4): per-step
   losses within max(1e-4, twice two eager runs' spread), each replay's
   camera, the first moments after one replayed step within 1e-3 of max,
   the Adam counts, step counter and visibility counts equal, parameters
   within 4 n lr, every kernel counted once per replayed step, and those
   counts (the capture's record times the replays) equal to the kernel
   launches ``torch.profiler`` sees in a chunk; (b) the trainer phase's
   run with ``steps_per_dispatch=0`` (chunks of 10): eval PSNR must rise
   and land within 1.0 dB of the per-step run's, ms per step per bucket
   beside the per-step path's, graphs and pool bytes, and with
   ``--profile`` one chunk's table, idle share and the same count check;
   (c) ``cli train
   --supervise`` at half resolution with its child killed at step 60
   (``QED_CRASH_ONCE_AT``): one restart, resumed from step 50, the journal
   matched; (d) ``cli train-multi``'s trainer on two names of the room,
   100 steps each, the graph pool before and after each scene's capture.
pipeline. the tools a user runs before and after training, through
   ``cli.main`` in this process, on the room and the trainer phase's run:
   ``init-pc`` with the JAX package's defaults into ``init_pc.ply`` (the
   seed cloud and transforms.json left as they are), one frame's
   backprojection and one colorize batch of 8 held against the CPU, the
   host core's voxel grid against ``ops/voxel.py`` (exactly under the
   core's own key; the plain key differs on the back wall, which lies on a
   multiple of the voxel: counted), then ``--colorize`` (at least 90% of
   the points coloured); ``eval-pc`` against the seed cloud (the core's
   distances equal the plain ``nn_distances`` on the card; accuracy p90 at
   most 0.05 m, completeness at least 90%); ``eval`` of the final
   checkpoint (PSNR, SSIM and depth abs_rel equal the run's own
   ``eval_all`` within 1e-4), LPIPS of seeded random alex and vgg nets on
   an eval frame against the CPU; ``render`` at 1296x840 in its three
   modes (orbit with depth, the eval cameras, a 4-keyframe camera path),
   frame 0 of each within one level of the plain path on 99.9% of pixels,
   and the CLI's launches of the compositing forward and the binning as
   ``kernels`` rows; ``export`` as .ply, .splat, point cloud and a cropped
   .ply, each read back and counted.
codec. the host core's image decoding: a room frame written with every row
   Paeth and every row Average, decoded by the core and by the plain row
   loops (equal, both timed; the all-Paeth frame must take under 0.1 s),
   and the committed baseline JPEG (``tests/data/room_1296x840_q90.jpg``).
bilateral. the room at 1296x840 with ``use_bilateral_grid``: 200 steps on
   the graph path with and without the grid (ms per step of each), then
   from the trained state a chunk of 10 steps as a CUDA graph against the
   per-step loop (losses within max(1e-4, twice two eager runs' spread),
   grids within max(1e-5, the same)), the grids off identity, ``tv_loss``
   in every train row, and the checkpoint's grids and moments bit-equal.
viewer. the room trained 60 steps with ``vis="viewer"`` on the graph path
   while a client thread renders once during the capture (the render waits
   for the capture lock), pauses (the step stands still across a wait while
   five full-size renders, ``/status``, ``/splats`` and ``/campath`` are
   answered) and resumes; then a replayed chunk against the per-step loop
   under concurrent renders, the launches of one render, the render and
   PNG-encode ms, and ``cli view`` on the run's checkpoint answering a
   render.
forest. BASELINE config #4: the forest (``testing.write_forest_dataset``,
   960x540, 40 frames) trained 3000 steps by ``cli train --supervise`` with
   ``tools/run_config4_r5.sh``'s flags in a child process: every loss
   finite, rc 0, eval PSNR at 3000 at least 3 dB above the seed state's
   and depth abs_rel lower; the final K, the last ``tile_overflow`` against
   the escalator's threshold 0.10 T K, refine and growth ms, the journal,
   and the child's kernel launches (``kernel_launches.json``); then on the
   final checkpoint the compositing forward and the binning held on an eval
   frame, and one step's gradients and the backward kernel on a training
   frame, against their plain versions.
sharded. ``parallel/*`` through gloo ranks sharing cuda:0 (one card:
   NCCL takes a card a rank), one job a mesh: which collectives gloo runs
   on CUDA tensors (``tools/gloo_probe.py``; the step's three must); (a)
   the JAX dryrun workload (``__graft_entry__.py``: 512x384, 65,536 / 40,000,
   K=256, SO3xR3, the grid, B=2, 2 steps) at 2x1, 1x2 and 2x2 against the
   1x1 mesh in this process (loss within 1e-4, ``vis_count`` equal, absgrad
   abs/scale 1e-3 and rel@sig 1e-2, means within 6 lr_means); (b) scene A
   at 2x2 (B=2) and B at 1x2 (K=2048, the chunked kernels) against 1x1,
   the loss within 1e-4 and every pre-Adam gradient within 1e-3 of its
   max, A at 2x2 with ``mixed_precision`` within 2e-2 of the f32 step, and
   the kernel rows of A 2x2 and B 1x2 on the step's own inputs (launches
   summed over the ranks); (c) ``cli train`` on the room, 200 steps at
   half resolution with the pair budget held, at 1x2 against the
   single-device per-step trainer (run twice: the first 10 losses within
   1e-4, the gaussians after the first refine within 0.1%, eval PSNR
   within 0.3 dB of the two runs' mean) and at 2x1 (eval PSNR at most
   1.0 dB under single, both with densification held off; with it on,
   the reading printed beside that bar), ``cli eval`` of rank 0's
   checkpoint equal to the run's own eval, ms per step of each.

Each render or train phase resets the kernels' launch counts, drives the
path, and fails unless every kernel of the path launched at least once per
frame or step; checks finite outputs; matches one frame or one step's
gradients against the plain path (``use_pallas=False``) on the card; holds
each kernel against its plain version on that run's own inputs; and times
the frame or step, each kernel, its plain version and its bound. The window
gather runs for microseconds, less than a launch costs the host, so its
times (kernel, plain version and library call alike) are taken from replays
of a captured CUDA graph; so are the binning kernels' (four launches) and
the compositing forward's, whose 0.2 ms is
of the order of what its differentiable entry point costs the host. A
step's gradients are held against the plain path on the state after the
steps and on the scene before any step; a pixel within rounding of a kink
of the loss, where the two paths' gradients differ by that pixel's whole
weight, is counted and masked out of both.

Prints the bench line, the tools' times, ``render_ms_per_frame`` /
``train_ms_per_step`` / ``bench`` / ``trainer`` / ``dispatch`` /
``pipeline`` / ``codec`` / ``bilateral`` / ``viewer`` / ``forest`` /
``sharded`` and ``kernels`` JSON lines, each phase's wall time,
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. The binning's rows in ``kernels`` count
the emit kernel's launches (one a frame, as each of the set's). Needs
CUDA; imports no JAX.
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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
    "binning": ("qed_splatter_tpu_torch/ops/tiles.py's dense expansion and "
                "sort; qed_splatter_tpu/ops/tiles.py:67 _slab_kernel's rank "
                "mode"),
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
           "copy_rows": f"{CSRC}/copy_rows.cu",
           "binning": f"{CSRC}/binning.cu"}
TRAIN_STEPS_WARM, TRAIN_STEPS_TIMED = 3, 20
# the witness build of both mixed kernels: the intrinsics (logf,
# __float2int_rn, __int2float_rn, __float2bfloat16_rn) in place of
# csrc/mixed.cuh's exact forms, against which the default builds are held
# bit-equal
WITNESS_DEFINES = ("-DQED_MIX_WITNESS=1",)
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


def opaque_block_case(gen, t, d, num_tiles_x, k, at, fade):
    """Slabs (counts K) in which every fourth tile holds 128 consecutive
    slots [at, at + 128) of alpha 0.999 over the whole tile: each rounded
    log is -6.90625, so the block's sum passes 2^24 units of 2^-15 (|E| >
    512) after 75 of them, where a float copy of the sum would stop being
    exact. ``fade``: the slots in front of the stack on those tiles are made
    faint (opacity x 0.02), so that a chunk in front stays open and the
    stack is composited inside the next chunk. Returns (slabs, counts, the
    tiles)."""
    counts = torch.full((t,), k, dtype=torch.int32, device="cuda")
    slabs = random_slabs(gen, t, k, d, counts, num_tiles_x)
    means, conics, _, opac = slabs
    sel = torch.zeros(t, dtype=torch.bool, device="cuda")
    sel[::4] = True
    tid = torch.arange(t, device="cuda")[sel]
    stack = slice(at, at + 128)
    means[sel, 0, stack] = ((tid % num_tiles_x) * 16 + 8.0)[:, None]
    means[sel, 1, stack] = ((tid // num_tiles_x) * 16 + 8.0)[:, None]
    conics[sel, :, stack] = torch.tensor([1e-6, 0.0, 1e-6],
                                         device="cuda")[None, :, None]
    opac[sel, 0, stack] = 0.999
    if fade:
        opac[sel, 0, :at] *= 0.02
    return slabs, counts, sel


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
        got = tiles.slab_gather(keys, starts, k, -1)
        want = tiles.slab_gather_ref(keys, starts, k, -1)
        check(torch.equal(got, want), f"slab_gather K={k} exact (starts 0, "
              f"M, past M, negative, M - 7; {n_odd} odd starts)")
    torch.cuda.synchronize()


# ------------------------------------------------------- phase binning

# the benchmark cells' binning shapes: (label, width, height, K); each frame
# 1,000,000 alive rows in a capacity of 2,097,152, pair budget 64
BIN_CELLS = (("forest", 960, 540, 4096), ("room late", 1296, 840, 2048),
             ("room densify", 1296, 840, 1024))
BIN_CAPACITY, BIN_ALIVE = 2_097_152, 1_000_000


def binning_inputs(width, height, seed):
    """Splats spread over the image, radii log-normal about 8 px (about 10
    tiles a splat: 600-1000 pairs a pixel, as in the cells' states), random
    depths; the rows past BIN_ALIVE culled."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = torch.tensor([width, height], device="cuda", dtype=torch.float32)
    m2d = torch.rand((BIN_CAPACITY, 2), generator=g, device="cuda") * size
    r = torch.exp(math.log(8.0) + 0.8 * torch.randn(
        BIN_CAPACITY, generator=g, device="cuda")).round().clamp(1, 400)
    alive = torch.arange(BIN_CAPACITY, device="cuda") < BIN_ALIVE
    radii = torch.where(alive, r, 0).to(torch.int32)
    depths = 0.5 + 20 * torch.rand(BIN_CAPACITY, generator=g, device="cuda")
    return m2d, radii, depths


def bin_kernel_ms(fn, reps):
    """Device ms a call of each binning kernel, from ``torch.profiler``
    over ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"bin_\w+_kernel(<\w+>)?", e.key)
        if name and e.device_time_total > 0:
            out[name.group(0)] = e.device_time_total / 1e3 / reps
    return out


def phase_binning(seed):
    """The binning kernel set (``csrc/binning.cu``) at each benchmark cell's
    shape: integer-equal to the plain path, one launch of each kernel a
    frame, its time beside its bound and the plain path's."""
    from qed_splatter_tpu_torch.ops import tiles

    print("phase binning: count, scan, place and emit at the cells' shapes",
          flush=True)
    entries, rows = [], {}
    for label, width, height, k in BIN_CELLS:
        m2d, radii, depths = binning_inputs(width, height, seed)
        kw = dict(max_per_tile=k, max_tiles_per_gaussian=64,
                  small_tiles_per_gaussian=64, with_id_lists=False)
        for kern in tiles.BIN_KERNELS:
            kern.reset()
        got = tiles.bin_gaussians(m2d, radii, depths, width, height, **kw)
        torch.cuda.synchronize()
        launches = {kern.symbol: kern.launches for kern in tiles.BIN_KERNELS}
        check(set(launches.values()) == {1},
              f"binning {label}: one launch of each kernel a frame")
        want = tiles.bin_gaussians(m2d, radii, depths, width, height,
                                   use_pallas=False, **kw)
        for f in ("order", "tile_counts", "num_truncated", "tile_ranks"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"binning {label}: {f} equal to the plain path")
        del want
        t = got.tile_counts.numel()
        pairs = int(got.tile_counts.sum())
        kept = int(got.tile_counts.clamp(max=k).sum())
        full = int((got.tile_counts >= k).sum())
        cols = torch.cat([m2d, radii[:, None].float()], -1)[got.order]
        spec = (16, got.num_tiles_x, got.num_tiles_y, k, 64, 64, 0)
        ms = graph_ms(lambda: tiles._bin_kernels(cols, *spec), 20)
        ms_all = graph_ms(lambda: tiles.bin_gaussians(
            m2d, radii, depths, width, height, **kw), 20)
        plain = cuda_ms(lambda: tiles.bin_gaussians(
            m2d, radii, depths, width, height, use_pallas=False, **kw), 2)
        per_kernel = bin_kernel_ms(lambda: tiles._bin_kernels(cols, *spec),
                                   10)
        # the least the card could do: read each row once, write the output
        bound_b = (BIN_CAPACITY * 12 + t * k * 8) / PEAK_BYTES_PER_S * 1e3
        each = ", ".join(f"{n} {v:.4f}" for n, v in per_kernel.items())
        print(f"  binning {label} ({width}x{height}, T={t}, K={k}): kernels "
              f"{ms:.4f} ms ({each}), "
              f"whole binning {ms_all:.4f} ms, plain {plain:.3f} ms; bound "
              f"{bound_b:.4f} ms (bytes), {ms / bound_b:.2f}x; pairs "
              f"{pairs}, kept {kept}, tiles at K {full} of {t}; launches "
              f"{launches}")
        rows[label] = {"ms": ms, "whole_binning_ms": ms_all,
                       "plain_ms": plain, "bound_ms": bound_b,
                       "per_kernel_ms": per_kernel, "pairs": pairs,
                       "kept": kept, "tiles_at_k": full, "tiles": t}
        entries.append(entry("binning", f"{label}, {width}x{height}, K={k}",
                             launches["qed_bin_emit"], 0.0, ms, plain, None,
                             bound_b, 0.0))
        del got, cols, m2d, radii, depths
        torch.cuda.empty_cache()
    return entries, rows


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

def run_masks(runs, counts, k, k_chunk):
    """[T, nb] and [T, nc] bool: the blocks and chunks of the mixed handoff
    that each tile ran (the kernel writes no other entry)."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    n_run = rp.slots_run(runs.shape[0], k, k_chunk, runs, counts,
                         runs.device)
    nb, nc = rp.mixed_shapes(k, k_chunk)
    kc = k_chunk if 0 < k_chunk < k else k
    first = torch.arange(max(nb, nc), device=runs.device)
    return ((first[:nb] * rp.MIX_BLOCK)[None] < n_run[:, None],
            (first[:nc] * kc)[None] < n_run[:, None])


def handoff_run(h, runs, counts, k, k_chunk):
    """(offsets, sums, trans) of a mixed handoff, 0 outside the blocks and
    chunks each tile ran."""
    blk, chk = run_masks(runs, counts, k, k_chunk)
    return (torch.where(blk[..., None], h.offsets, 0.0),
            torch.where(blk[..., None], h.sums, 0),
            torch.where(chk[..., None], h.trans, 0.0))


def check_fwd_mixed(slabs, ntx, counts, k_chunk, label, poison=False):
    """The mixed forward kernel with its handoff against its plain version
    on the same slabs and counts: out and acc within TOL, the chunks run
    equal, and over the blocks and chunks each tile ran, the block sums of
    the rounded logs equal and the offsets (float32 sums in another order)
    and chunk transmittances within TOL relative; every output bit-equal to
    the witness build (WITNESS_DEFINES). With ``poison`` also: NaN at and
    past each tile's count changes no output. Returns (chunks run, handoff,
    max abs err)."""
    from qed_splatter_tpu_torch.cuda import CudaKernel
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    t, _, k = slabs[2].shape
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    runs_ref = torch.empty_like(runs)
    out, acc, h = rp.composite_tiles_fwd_mixed(*slabs, ntx, 16, counts,
                                               k_chunk, runs, tail=True)
    ro, ra, hr = rp.composite_tiles_ref(*slabs, ntx, 16, counts, k_chunk,
                                        runs_ref, tail=True, mixed=True)
    err = max(max_abs(out, ro), max_abs(acc, ra))
    blk, chk = run_masks(runs, counts, k, k_chunk)
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
    main = rp.COMPOSITE_MIXED
    rp.COMPOSITE_MIXED = CudaKernel(main.source, main.symbol,
                                    main.argtypes[:-1], WITNESS_DEFINES)
    try:
        runs_w = torch.empty_like(runs)
        wo, wa, wh = rp.composite_tiles_fwd_mixed(*slabs, ntx, 16, counts,
                                                  k_chunk, runs_w, tail=True)
    finally:
        rp.COMPOSITE_MIXED = main
    check(torch.equal(wo, out) and torch.equal(wa, acc)
          and torch.equal(runs_w, runs)
          and all(torch.equal(x, y) for x, y in zip(
              handoff_run(wh, runs, counts, k, k_chunk),
              handoff_run(h, runs, counts, k, k_chunk))),
          f"{label}: bit-equal to the witness build (the intrinsics)")
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
    as the identity) within BWD_TOL of each channel's max, and bit-equal to
    its witness build (WITNESS_DEFINES)."""
    from qed_splatter_tpu_torch.cuda import CudaKernel
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    args = (*slabs, gout, gacc, ntx, 16, k_chunk, runs, counts, handoff)
    got = rp.composite_tiles_bwd_mixed(*args)
    want = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, 16,
                                      k_chunk=k_chunk, chunks_run=runs,
                                      tile_counts=counts, mixed=True)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{label}: gradients finite")
    main = rp.COMPOSITE_BWD_MIXED
    rp.COMPOSITE_BWD_MIXED = CudaKernel(main.source, main.symbol,
                                        main.argtypes[:-1], WITNESS_DEFINES)
    try:
        witness = rp.composite_tiles_bwd_mixed(*args)
    finally:
        rp.COMPOSITE_BWD_MIXED = main
    check(all(torch.equal(a, b) for a, b in zip(got, witness)),
          f"{label}: bit-equal to the witness build (the intrinsics: the "
          "inline log is logf's, so T is the forward's)")
    return check_bwd(got, want, runs, k_chunk, label, counts)


def mixed_bwd_shares(slabs, ntx, counts, runs, k_chunk, handoff):
    """What ``composite_bwd.cu``'s mixed kernel leaves out on these inputs,
    and what a skip behind T = 0 would, computed from the slabs and the
    forward's handoff in plain torch (not counted in the kernel). A warp of
    that kernel holds four whole rows of the tile, pixels [64 w, 64 w + 64).
    Returns the share of needed (warp, slot) pairs culled before the exp
    (no pixel of the warp has sigma < log(255 op) + 1e-4), the share of
    (warp, block) pairs the tile runs that lie behind T = 0 (exp(offset) =
    0 on all of the warp's pixels: every term of the block is an exact
    zero), and the share of needed (warp, slot) pairs inside those
    blocks."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    means, conics, _, opac = (x.detach() for x in slabs)
    t, _, k = means.shape
    n_run = rp.slots_run(t, k, k_chunk, runs, counts, "cuda")
    nb = handoff.offsets.shape[1]
    first = torch.arange(nb, device="cuda") * rp.MIX_BLOCK
    blk_run = first[None] < n_run[:, None]                       # [T, nb]
    dark = (torch.exp(handoff.offsets) == 0).view(t, nb, 4, 64).all(-1)
    dark = dark & blk_run[..., None]                             # [T, nb, 4]
    in_blk = (n_run[:, None] - first[None]).clamp(0, rp.MIX_BLOCK)
    thr = torch.log(255.0 * opac[:, 0]) + 1e-4                   # [T, K]
    slot = torch.arange(k, device="cuda")
    culled = 0
    step = max(1, (1 << 24) // (256 * k))
    for s in range(0, t, step):
        sl = slice(s, s + step)
        tid = torch.arange(s, min(s + step, t), device="cuda")
        dx, dy = rp._alpha_local(means[sl], conics[sl], opac[sl], tid, ntx,
                                 16)[:2]
        ca, cb, cc = (conics[sl, None, c, :] for c in range(3))
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        near = (sigma < thr[sl, None, :]).view(-1, 4, 64, k).any(2)
        run = slot[None, :] < n_run[sl, None]                    # [Tc, K]
        culled += int((~near & run[:, None, :]).sum())
    needed = 4 * int(n_run.sum())
    return (culled / max(needed, 1),
            int(dark.sum()) / max(4 * int(blk_run.sum()), 1),
            int((dark * in_blk[..., None]).sum()) / max(needed, 1))


def mixed_fwd_shares(slabs, ntx, counts, runs, k_chunk):
    """What ``composite.cu``'s mixed kernel leaves out on these inputs,
    computed from the slabs in plain torch (not counted in the kernel). A
    warp of that kernel holds an 8 x 8 block of the tile (rows from
    8 (w >> 1), columns from 8 (w & 1)). Returns the shares of the needed
    (warp, slot) pairs culled before the exp (no pixel of the warp has
    sigma < log(255 op) + 1e-4) and after the exact keep (no pixel keeps the
    slot; the first share included)."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    means, conics, _, opac = (x.detach() for x in slabs)
    t, _, k = means.shape
    n_run = rp.slots_run(t, k, k_chunk, runs, counts, "cuda")
    thr = torch.log(255.0 * opac[:, 0]) + 1e-4                   # [T, K]
    slot = torch.arange(k, device="cuda")

    def by_warp(x):               # [Tc, P, K] -> any over each warp's pixels
        return x.view(-1, 2, 8, 2, 8, k).any(4).any(2).view(-1, 4, k)

    culled = unkept = 0
    step = max(1, (1 << 24) // (256 * k))
    for s in range(0, t, step):
        sl = slice(s, s + step)
        tid = torch.arange(s, min(s + step, t), device="cuda")
        dx, dy, _, _, keep, _ = rp._alpha_local(means[sl], conics[sl],
                                                opac[sl], tid, ntx, 16)
        ca, cb, cc = (conics[sl, None, c, :] for c in range(3))
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        run = (slot[None, :] < n_run[sl, None])[:, None, :]      # [Tc, 1, K]
        culled += int((~by_warp(sigma < thr[sl, None, :]) & run).sum())
        unkept += int((~by_warp(keep) & run).sum())
    needed = 4 * int(n_run.sum())
    return culled / max(needed, 1), unkept / max(needed, 1)


def phase_mixed_parity(gen):
    """The mixed_precision kernels against their plain versions on random
    slabs: K = 256 (two 128-slot blocks) with counts, an odd K with counts
    of 0, 1, K and past K, 24-deep opaque stacks (E far below float32's
    exp range), chunked at K = 2048, and an opaque block (128 slots of
    alpha 0.999: the block's sum passes 2^24 units) alone at K = 256 and
    inside chunk 2 at K = 2048."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    print("phase 2c: the mixed_precision kernels against their plain "
          "versions", flush=True)
    ntx, nty = -(-W // 16), -(-H // 16)
    t = ntx * nty
    cases = []
    counts = torch.randint(0, 257, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    cases.append(("K=256 D=4, counted", random_slabs(gen, t, 256, 4, counts,
                                                      ntx), counts, 0, True,
                  None))
    low = torch.randint(0, 97, (t,), generator=gen, device="cuda",
                        dtype=torch.int32)
    low[:4] = torch.tensor([0, 1, 333, 383], device="cuda",
                           dtype=torch.int32)
    cases.append(("K=333 D=3, counts below 97 (and 0, 1, K, past K)",
                  random_slabs(gen, t, 333, 3, low, ntx), low, 0, True,
                  None))
    deep = torch.zeros(t, dtype=torch.bool, device="cuda")
    deep[::3] = True
    full = torch.full((t,), 256, dtype=torch.int32, device="cuda")
    cases.append(("K=256 D=4, 24-deep opaque stacks",
                  random_slabs(gen, t, 256, 4, full, ntx, deep, depth=24),
                  full, 0, False, None))
    slabs, counts = chunked_case(gen, t, 4, ntx, 2048)
    cases.append(("chunked K=2048 D=4, counted", slabs, counts, rp.K_CHUNK,
                  True, None))
    slabs, counts, sel = opaque_block_case(gen, t, 4, ntx, 256, 128, False)
    cases.append(("K=256 D=4, an opaque block (slots 128-255)", slabs,
                  counts, 0, False, (sel, 1)))
    at = rp.K_CHUNK + 128
    slabs, counts, sel = opaque_block_case(gen, t, 4, ntx, 2048, at, True)
    cases.append((f"chunked K=2048 D=4, an opaque block in chunk 2 (slots "
                  f"{at}-{at + 127})", slabs, counts, rp.K_CHUNK, False,
                  (sel, at // rp.MIX_BLOCK)))
    errs = {}
    for label, slabs, counts, k_chunk, poison, opaque in cases:
        d = slabs[2].shape[1]
        runs, h, err = check_fwd_mixed(slabs, ntx, counts, k_chunk,
                                       f"composite mixed T={t} {label}",
                                       poison)
        if opaque is not None:
            sel, b = opaque
            run_all = bool((runs[sel] == (2 if k_chunk else 1)).all())
            print(f"  the opaque block {b}: block sums on its tiles "
                  f"{int(h.sums[sel, b].max())} to {int(h.sums[sel, b].min())} "
                  f"units")
            check(run_all and bool((h.sums[sel, b] < -(1 << 24)).all()),
                  "every pixel of the opaque tiles ran the block, and its sum "
                  "passes 2^24 units")
        elif k_chunk:
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


def frame_kernel_entries(params, c2w, K, width, height, cfg, step, label_k,
                         launches):
    """The ``kernels`` rows of the compositing forward and the binning's
    kernel set for one frame of ``render(train=False)``: each held against
    its plain version and timed, with the plain version (and the library
    form where there is one), on that frame's own inputs. ``launches`` are
    the main path's counts by kernel ("composite", "binning": the emit
    kernel's, one a binning)."""
    from qed_splatter_tpu_torch.models.splatfacto import render
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    # --- the kernels on this frame's own inputs
    with Capture(rp, "composite_tiles_chunked") as cap_c, \
            Capture(tiles, "_bin_kernels") as cap_g:
        render(params, c2w, K, width, height, cfg, step=step)
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
    b_bytes_c = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_F32_PER_S * 1e3

    # the binning's kernel set on the frame's depth-ordered rows, against
    # its plain version on the same rows
    cols, spec = cap_g.args[0], cap_g.args[1:]
    t_all, kk = spec[1] * spec[2], spec[3]
    for a, b in zip(tiles._bin_kernels(cols, *spec),
                    tiles._bin_dense(cols, *spec)):
        check(torch.equal(a, b), "binning kernels on frame inputs exact")
    ms_b = graph_ms(lambda: tiles._bin_kernels(cols, *spec), 20)
    plain_b = cuda_ms(lambda: tiles._bin_dense(cols, *spec), 2)
    b_bytes = (cols.numel() * 4 + t_all * kk * 8) / PEAK_BYTES_PER_S * 1e3
    bound_c = max(b_bytes_c, b_ops)
    print(f"  composite {ms_c:.4f} ms ({host_c:.4f} ms launched from the "
          f"host through autograd; plain {plain_c:.3f} ms), bound "
          f"{bound_c:.4f} ms ({b_ops:.4f} by operations, {b_bytes_c:.4f} by "
          f"bytes), {ms_c / bound_c:.2f}x its bound; "
          f"{needed_slots(counts, runs, k, k_chunk)} of {t * k} slots needed")
    print(f"  binning kernels {ms_b:.4f} ms (plain {plain_b:.3f} ms), bound "
          f"{b_bytes:.4f} ms (bytes of the rows and the [T, K] ranks), "
          f"{ms_b / b_bytes:.2f}x")
    entries = [
        entry("composite", label_k, launches["composite"], err_abs, ms_c,
              plain_c, None, b_bytes_c, b_ops),
        entry("binning", label_k, launches["binning"], 0.0, ms_b, plain_b,
              None, b_bytes, 0.0),
    ]
    # ms is the kernel alone (graph replays); launched from the host through
    # its differentiable entry point, as earlier runs timed it:
    entries[0]["ms_launched_from_host"] = host_c
    return entries


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
    for kern in (rp.COMPOSITE, *tiles.BIN_KERNELS):
        kern.reset()
    outs = [render(params, c2w, K, W, H, cfg, step=30_000) for c2w, K in cams]
    torch.cuda.synchronize()
    launches = {"composite": rp.COMPOSITE.launches,
                "binning": tiles.BIN_EMIT.launches}
    chunked = rp.COMPOSITE.variant_launches.get("chunked", 0)
    print(f"  launches {launches}, chunked composite launches {chunked}")
    check(all(v >= n_cams for v in launches.values()),
          "every kernel launched on the main path")
    check(all(k.launches == launches["binning"] for k in tiles.BIN_KERNELS),
          "one launch of each binning kernel a frame")
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

    entries = frame_kernel_entries(params, c2w, K, W, H, cfg, 30_000,
                                   f"scene {label}, K={k_cap}", launches)

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


KINKS = ("l1_sign", "clamp", "clamp_opaque", "depth_sign", "alpha_zero")
# how near the clamp's edge at 0 a channel of an opaque pixel lies, and how
# near 1 its alpha, for the pair of values to be rounding: alpha rounds 2 ulp
# above 1 and 4e-7 below it on the forest, (1 - alpha) bg rounds to 2.5e-7
OPAQUE_EPS = 1e-6


@torch.no_grad()
def loss_branch_kinds(a, b, batch):
    """{kind: [H, W] bool}: the pixels where the loss takes another branch
    of one of its kinks on the frames ``a`` and ``b`` that two paths
    rendered of one state, by kind: the sign of the RGB L1 term (rgb - gt
    per channel), the clamp of rgb to [0, 1], the sign of the depth L1 term
    (depth - gt), and depth's fallback where alpha is 0. Frames that agree
    to rounding still fall on either side of a kink where a pixel lies
    within rounding of it, and there the two gradients differ by that
    pixel's whole weight.

    The clamp passes the gradient at an edge itself (``torch.clamp``'s
    backward is inclusive) and cuts it beyond. Before the clamp rgb is
    render + (1 - alpha) bg with render >= 0, so a 0 lies beyond the edge
    only where (1 - alpha) bg < 0: an opaque pixel whose alpha (a sum of
    weights) rounds above 1, on a channel every splat there renders 0. On
    such a channel rgb before the clamp is (1 - alpha) bg on both paths,
    rounding about the edge, and its sign is each path's rounding: a
    trained state has such pixels, and the count that lands on two sides
    varies from training to training. A clamp kink where, on
    both paths, alpha lies within ``OPAQUE_EPS`` of 1 and every channel
    on two sides within ``OPAQUE_EPS`` of 0 is of kind ``clamp_opaque``;
    every other one (a 1, which may lie at the edge or beyond it and counts
    as beyond, or a 0 with more than rounding before the clamp) is of kind
    ``clamp``."""
    rgb, depth = batch["rgb"], batch["depth"]

    def cut(o):
        return (o.rgb == 1.0) | ((o.rgb == 0.0) & (
            (1.0 - o.accumulation) * o.background < 0.0))

    def at_edge(o):
        return (o.rgb <= OPAQUE_EPS) & (
            (1.0 - o.accumulation).abs() <= OPAQUE_EPS)

    flip = cut(a) != cut(b)
    opaque = flip.any(-1) & (~flip | (at_edge(a) & at_edge(b))).all(-1)
    return {
        "l1_sign": (torch.sign(a.rgb - rgb)
                    != torch.sign(b.rgb - rgb)).any(-1),
        "clamp": flip.any(-1) & ~opaque,
        "clamp_opaque": opaque,
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
    all. Kind ``clamp_opaque`` is bound by what it is, both paths within
    rounding of the clamp's edge, and not by a count (see
    :func:`loss_branch_kinds`). Returns the count of each kind."""
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
        check(n_kinks - by_kind["clamp_opaque"] <= 8, "at most 8 pixels lie "
              "within rounding of a kink of the loss, besides clamp_opaque")
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


def bwd_entry(cap, cap_f, label, launches):
    """The ``kernels`` row of the compositing backward on one step's own
    inputs (``cap`` recorded ``composite_tiles_bwd``, ``cap_f`` the
    forward): the forward's handoff held bit-equal to the plain version, the
    kernel held against its plain version, both timed beside the bound."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

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

    row = entry("composite_bwd", label, launches, err, ms, plain_ms, None,
                bound_b, bound_o)
    row["forward_ms_with_handoff"] = ms_fwd[True]
    row["forward_ms_without_handoff"] = ms_fwd[False]
    return row


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
    for kern in (rp.COMPOSITE, rp.COMPOSITE_BWD, *tiles.BIN_KERNELS):
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
                "binning": tiles.BIN_EMIT.launches}
    chunked_bwd = rp.COMPOSITE_BWD.variant_launches.get("chunked", 0)
    print(f"  launches {launches}, chunked composite_bwd launches "
          f"{chunked_bwd}")
    check(all(v >= n_steps for v in launches.values()),
          f"every kernel launched at least once per step ({n_steps} steps)")
    check(launches["composite_bwd"] == n_steps
          and all(k.launches == n_steps for k in tiles.BIN_KERNELS),
          "one composite_bwd and one binning kernel set per step")
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
        fresh = spread_state(n_alive, capacity, seed, optims)
        hold(fresh, step.grads(fresh, batch, torch.Generator(
            device="cuda").manual_seed(seed_bg)), "before any step",
            FRESH_TOL)
        del fresh

    entries = [bwd_entry(cap, cap_f, f"train {label}, K={k_cap}",
                         launches["composite_bwd"])]

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

    del state, got, params, cap, cap_f
    torch.cuda.empty_cache()
    return entries, step_ms


def spread_state(n_alive, capacity, seed, optims):
    """The train state of :func:`make_scene`'s scene before any step, its
    log-scales spread by N(0, 0.4) (isotropic scales give the rotations no
    gradient): the state on which the mixed phase holds and times its
    kernels, the same from run to run."""
    from qed_splatter_tpu_torch.engine.train_step import init_train_state

    fresh = make_scene(n_alive, capacity, seed)
    spread = np.random.default_rng(seed + 1).normal(
        0, 0.4, tuple(fresh.scales.shape)).astype(np.float32)
    return init_train_state(fresh.replace(
        scales=fresh.scales + torch.as_tensor(spread, device="cuda")),
        optims, num_cameras=4)


def background_generator(seed):
    """The random background's generator of that held step."""
    return torch.Generator(device="cuda").manual_seed(seed + 29)


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
               "binning": tiles.BIN_EMIT}
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
          and launches["binning"] == n_steps,
          "one mixed composite, one mixed composite_bwd and one binning "
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
    def bg():
        return background_generator(seed)

    del state
    state = spread_state(n_alive, capacity, seed, optims)
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
    culled, dark, in_dark = mixed_bwd_shares(slabs, ntx, counts, runs,
                                             k_chunk, h)
    f_culled, f_unkept = mixed_fwd_shares(slabs, ntx, counts, runs, k_chunk)
    print(f"  composite mixed on the step's slabs: {f_culled:.4f} of the "
          f"needed (warp, slot) pairs culled before the exp, {f_unkept:.4f} "
          f"after the exact keep")
    print(f"  composite_bwd mixed on the step's slabs: {culled:.4f} of the "
          f"needed (warp, slot) pairs culled before the exp; {dark:.4f} "
          f"of the (warp, block) pairs run lie behind T = 0, holding "
          f"{in_dark:.4f} of the needed pairs")
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
    entries[0]["work_shares"] = {"culled_pairs": f_culled,
                                 "unkept_pairs": f_unkept}
    entries[1]["work_shares"] = {"culled_pairs": culled,
                                 "blocks_behind_t0": dark,
                                 "pairs_behind_t0": in_dark}
    del state, gm, params, slabs, fargs, bargs, gout, gacc, h
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
    paths = {}
    for label, n in (("327k", bench_gather3.N_TAB),
                     ("4p4M", bench_gather3.M_IDX)):
        x = torch.rand((n, bench_gather3.C), generator=gen, device="cuda")
        seen = dict(cr.COPY_ROWS.variant_launches)
        y = cr.copy_rows(x)
        torch.cuda.synchronize()
        took = [p for p, v in cr.COPY_ROWS.variant_launches.items()
                if v != seen.get(p, 0)]
        paths[label] = took[0] if len(took) == 1 else None
        check(torch.equal(y, cr.copy_rows_ref(x)) and y.data_ptr()
              != x.data_ptr(), f"copy_rows [{n}, {bench_gather3.C}] "
              f"bit-equal to its plain version (path {paths[label]})")
        check(paths[label] == "bulk", f"copy_rows [{n}, {bench_gather3.C}] "
              "took the bulk path")
        b7 = 2 * x.numel() * 4 / PEAK_BYTES_PER_S * 1e3
        rows[label] = {"ms": t7[f"copy_{label}"],
                       "plain_ms": t7[f"copy_{label}_plain"],
                       "library_ms": t7[f"copy_{label}_library"],
                       "bound_ms": b7, "path": paths[label],
                       "into_ms": t7[f"copy_{label}_into"]}
        r = rows[label]
        print(f"  copy_rows {label}: path {r['path']}, {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}); into a preallocated tensor "
              f"{r['into_ms']:.4f} ms, Tensor.copy_ {r['library_ms']:.4f}; "
              f"bound {b7:.4f} ms by bytes")
        del x, y
    r = rows["4p4M"]
    entries.append(entry("copy_rows", "tools/bench_gather3, [4396032, 10]",
                         l7, 0.0, r["ms"], r["plain_ms"], r["library_ms"],
                         r["bound_ms"], 0.0))
    entries[-1].update(path=r["path"], into_ms=r["into_ms"])
    entries[-1]["at_327680_rows"] = rows["327k"]
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


def card_state():
    """The card's SM clock, power draw and temperature now (a phase's
    times are comparable only at the same clocks)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def write_room(root):
    """The room dataset the trainer and dispatch phases train on: seconds
    of ray casts."""
    from qed_splatter_tpu_torch import testing

    t0 = time.perf_counter()
    testing.write_room_dataset(root, num_frames=TRAINER_FRAMES, width=W,
                               height=H, sparse_ply=TRAINER_POINTS,
                               workers=min(8, os.cpu_count() or 1))
    return time.perf_counter() - t0


def phase_trainer(seed, profile_dir, root, t_data, out_dir):
    """The trainer phase; its run (checkpoints, metrics) stays in
    ``out_dir`` for the pipeline phase."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.train_step import make_train_step
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase trainer: room dataset {W}x{H}, {TRAINER_FRAMES} frames, "
          f"{TRAINER_POINTS} seed points, {TRAINER_STEPS} steps + a resume "
          f"of {TRAINER_RESUME} (card: {card_state()})", flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = Path(tmp) / "trace"
        cfg = trainer_config(str(root), str(out_dir), seed, str(trace_dir))
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
        kernels = (rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.BIN_EMIT)
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
                    "binning": tiles.BIN_EMIT.launches}
        variants = {"composite chunked": rp.COMPOSITE.variant_launches.get(
            "chunked", 0), "composite_bwd chunked":
            rp.COMPOSITE_BWD.variant_launches.get("chunked", 0)}
        print(f"  {TRAINER_STEPS} steps in {t_train:.2f} s with their "
              f"refines, evals and checkpoints (card after: {card_state()}); "
              f"launches {launches}, "
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


# --------------------------------------------------------- dispatch phase

DISPATCH_CASES = (      # label, alive, capacity, K, steps, mixed_precision
    ("A", 80_000, 131_072, 256, 10, False),
    ("B", 288_000, 327_680, 2048, 4, False),
    ("A mixed", 80_000, 131_072, 256, 4, True),
)
SUPERVISED_STEPS, SUPERVISED_SAVE, SUPERVISED_CRASH = 100, 50, 60
MULTI_STEPS = 100


def dispatch_items(n_cams, seed):
    """Orbit frames of the synthetic scenes as dataset items: uniform RGB
    (uint8) and depth uniform in 0.5-4.0, as ``train_batch``'s."""
    from qed_splatter_tpu_torch.ops.camera import Camera

    rng = np.random.default_rng(seed)
    items = []
    for i, (c2w, K) in enumerate(cameras(n_cams)):
        cam = Camera(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), width=W, height=H,
                     c2w=np.asarray(c2w, np.float32), cam_idx=i)
        items.append({"camera": cam, "cam_idx": i, "image": rng.integers(
            0, 256, (H, W, 3), dtype=np.uint8), "depth_image": rng.uniform(
                0.5, 4.0, (H, W, 1)).astype(np.float32)})
    return items


def eager_chunk(runner, state, perm, bgs):
    """The per-step loop on the runner's step, frames and backgrounds:
    (state, per-step losses, ms per step by CUDA events)."""
    import dataclasses

    data = runner.dataset.data
    gen = torch.Generator(device="cuda")
    losses = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i, p in enumerate(perm):
        batch = {"c2w": data["c2w"][p], "K": data["K"][p],
                 "cam_idx": int(data["cam_idx"][p]),
                 "rgb": runner._unit[data["rgb_u8"][p].long()],
                 "depth": data["depth"][p]}
        inp = runner.step.inputs(batch, gen, state.step)
        inp.background = bgs[i]
        losses.append(runner.step.run(state, inp)["loss"])
        state = dataclasses.replace(state, step=state.step + 1)
    end.record()
    torch.cuda.synchronize()
    return state, [float(x) for x in losses], start.elapsed_time(end) / len(
        perm)


def graph_chunk(runner, state, perm, bgs):
    """One runner call: (state, [n, M] metrics on the host, ms per step by
    CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    state, metrics = runner(state, perm, bgs)
    end.record()
    torch.cuda.synchronize()
    return state, dict(zip(runner.names, metrics.cpu().numpy().T)), \
        start.elapsed_time(end) / len(perm)


# the device function each wrapper launches once per host call, by the
# name torch.profiler gives its kernel
DEVICE_FNS = {"qed_composite_tiles": "composite_kernel<",
              "qed_composite_tiles_bwd": "composite_bwd_kernel<",
              "qed_composite_tiles_mixed": "composite_mixed_kernel<",
              "qed_composite_tiles_bwd_mixed": "composite_bwd_mixed_kernel<",
              "qed_slab_gather": "slab_gather_kernel<",
              "qed_bin_emit": "bin_emit_kernel"}


def kernel_events(prof, kernels):
    """Launches of each wrapper's device function that ``prof`` saw run on
    the card, by symbol: what a graph's replays really launched."""
    pats = {k.symbol: re.compile(r"\b" + re.escape(DEVICE_FNS[k.symbol]))
            for k in kernels}
    seen = dict.fromkeys(pats, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for sym, pat in pats.items():
                seen[sym] += bool(pat.search(e.name))
    return seen


def profiled_launches(fn, kernels):
    """Runs ``fn()`` under ``torch.profiler``: (launches each wrapper
    counted, launches the profiler saw), by symbol."""
    from torch.profiler import ProfilerActivity, profile

    before = {k.symbol: k.launches for k in kernels}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counted = {k.symbol: k.launches - before[k.symbol] for k in kernels}
    return counted, kernel_events(prof, kernels)


def runner_pool_bytes(runner):
    """Bytes of the graph pool a scan runner captured into (None before
    its capture)."""
    from qed_splatter_tpu_torch.engine import scan_runner

    if runner._graph is None:
        return None
    return scan_runner.pool_bytes(runner.pool or runner._graph.pool(), "cuda")


def dispatch_case(label, n_alive, capacity, k_cap, n, mixed, seed):
    """(a): a chunk as a CUDA graph against the per-step loop from one state,
    perm and backgrounds."""
    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.checkpoint import copy_state
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.scan_runner import DeviceDataset, \
        make_scan_steps
    from qed_splatter_tpu_torch.engine.trainer import downscale_depth, \
        downscale_image
    from qed_splatter_tpu_torch.models.splatfacto import background_color
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    t0 = time.perf_counter()
    cfg = ModelConfig(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                      background_color="random", mixed_precision=mixed)
    optims = GroupOptimizers(default_optimizers())
    state0 = spread_state(n_alive, capacity, seed, optims)
    ds = DeviceDataset(dispatch_items(4, seed), 1, downscale_image,
                       downscale_depth, "cuda")
    runner = make_scan_steps(cfg, optims, ds, n, device="cuda")
    one = make_scan_steps(cfg, optims, ds, 1, device="cuda")
    perm = np.random.default_rng(seed).integers(0, 4, n).tolist()
    bgs = torch.stack([background_color(cfg, "cuda", True, torch.Generator(
        device="cuda").manual_seed(seed + 31 + i)) for i in range(n)])
    # first calls capture (their step 1 runs eagerly): on throwaway copies
    runner(copy_state(state0, "cuda"), perm, bgs)
    one(copy_state(state0, "cuda"), perm[:1], bgs[:1])
    torch.cuda.synchronize()
    print(f"  case {label}: {n_alive} alive / {capacity}, K={k_cap}, "
          f"{'mixed, ' if mixed else ''}{n} steps; set-up and capture "
          f"{time.perf_counter() - t0:.2f} s, graph pool "
          f"{runner_pool_bytes(runner)} bytes", flush=True)

    e1, losses1, eager_ms = eager_chunk(runner, copy_state(state0, "cuda"),
                                        perm, bgs)
    e2, losses2, _ = eager_chunk(runner, copy_state(state0, "cuda"), perm,
                                 bgs)
    kernels = [rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.BIN_EMIT,
               rp.COMPOSITE_MIXED, rp.COMPOSITE_BWD_MIXED]
    for kern in kernels:
        kern.reset()
    replays0 = runner.replays
    g, rows, graph_ms = graph_chunk(runner, copy_state(state0, "cuda"), perm,
                                    bgs)
    launches = {k.symbol: k.launches for k in kernels if k.launches}
    variants = {f"{k.symbol} {v}": c for k in kernels
                for v, c in k.variant_launches.items()}
    spread = max(abs(a - b) / abs(b) for a, b in zip(losses1, losses2))
    err = float(max(abs(a - b) / abs(b)
                    for a, b in zip(rows["loss"], losses1)))
    bar = max(1e-4, 2 * spread)
    print(f"    per-step loss: graph against eager {err:.3e}, eager against "
          f"eager {spread:.3e} (bar {bar:.3e}); graph {graph_ms:.3f} ms per "
          f"step, eager {eager_ms:.3f} (CUDA events); launches {launches} "
          f"{variants} in {runner.replays - replays0} replays")
    check(err <= bar, f"case {label}: per-step losses within {bar:.1e}")
    check(rows["cam_idx"].tolist() == [float(p) for p in perm],
          f"case {label}: each replay read its camera")
    check(all(np.isfinite(rows["loss"])), f"case {label}: finite losses")
    # the path's kernels, every one launched inside the replays
    want = ([rp.COMPOSITE_MIXED, rp.COMPOSITE_BWD_MIXED] if mixed
            else [rp.COMPOSITE, rp.COMPOSITE_BWD]) + [tiles.BIN_EMIT]
    check(runner.replays - replays0 == n
          and all(k.launches == n for k in want),
          f"case {label}: every kernel counted once per replayed step")
    if k_cap > rp.K_CHUNK:
        check(want[0].variant_launches.get("chunked") == n
              and want[1].variant_launches.get("chunked") == n,
              f"case {label}: the chunked kernels replayed")
    # the replays' counts are the capture's record times the replays: hold
    # them to the kernels the profiler saw run in another chunk of n
    counted, seen = profiled_launches(
        lambda: runner(copy_state(state0, "cuda"), perm, bgs), want)
    print(f"    a profiled chunk of {n} replays: counted {counted}, the "
          f"profiler saw {seen}")
    check(counted == seen == {k.symbol: n for k in want},
          f"case {label}: the profiler saw each counted kernel launch")

    # each group's first moment after one replayed step (mu = 0.1 g): the
    # gradient bar, or twice what two eager steps differ by where a pixel
    # within rounding of a kink of the loss takes another branch
    g1, _, _ = graph_chunk(one, copy_state(state0, "cuda"), perm[:1],
                           bgs[:1])
    e1s, _, _ = eager_chunk(one, copy_state(state0, "cuda"), perm[:1],
                            bgs[:1])
    e2s, _, _ = eager_chunk(one, copy_state(state0, "cuda"), perm[:1],
                            bgs[:1])

    def moments(st):
        return {**{grp: st.opt_state[grp]["mu"] for grp in st.opt_state},
                "camera_opt": st.camera_opt_state["mu"]}

    def mu_errs(x, y):
        return {k: float((x[k] - y[k]).abs().max()) / max(
            float(y[k].abs().max()), 1e-30) for k in y}

    mu_err = mu_errs(moments(g1), moments(e1s))
    mu_spread = mu_errs(moments(e2s), moments(e1s))
    print(f"    first moments after one replayed step, of each max: graph "
          f"{ {k: f'{v:.2e}' for k, v in mu_err.items()} }, eager against "
          f"eager { {k: f'{v:.2e}' for k, v in mu_spread.items()} }")
    check(all(v <= max(BWD_TOL, 2 * mu_spread[k])
              for k, v in mu_err.items()),
          f"case {label}: mu after step 1 within {BWD_TOL} of max")

    # after the chunk: exact counts, parameters near the eager ones
    counts_ok = all(int(g.opt_state[k]["count"]) == int(e1.opt_state[k][
        "count"]) == n for k in g.opt_state) and int(
        g.camera_opt_state["count"]) == int(e1.camera_opt_state["count"])
    vis_diff = int((g.stats.vis_count != e1.stats.vis_count).sum())
    vis_spread = int((e2.stats.vis_count != e1.stats.vis_count).sum())
    print(f"    Adam counts equal {counts_ok}; step counter "
          f"{int(runner.step_counter)}; vis_count slots differing: graph "
          f"{vis_diff}, eager against eager {vis_spread}")
    check(counts_ok and int(runner.step_counter) == g.step == e1.step,
          f"case {label}: the Adam counts and the step counter equal")
    check(vis_diff <= vis_spread, f"case {label}: vis_count equal (as "
          "equal as two eager runs)")
    far = {}
    for grp in g.opt_state:
        lr = optims.configs[grp].lr
        d = float((getattr(g.params, grp) - getattr(e1.params, grp)).abs()
                  .max())
        far[grp] = d / (4 * n * lr)
    print(f"    params after the chunk, max |graph - eager| / (4 n lr): "
          f"{ {k: f'{v:.2e}' for k, v in far.items()} }")
    check(all(v <= 1.0 for v in far.values()),
          f"case {label}: every parameter within 4 n lr of the eager one")
    out = {"steps": n, "loss_rel_err": err, "eager_spread": spread,
           "graph_ms_per_step": graph_ms, "eager_ms_per_step": eager_ms,
           "launches": launches, "variants": variants, "mu_err": mu_err,
           "pool_bytes": runner_pool_bytes(runner)}
    del runner, one, state0, g, e1, e2, g1, e1s, e2s
    torch.cuda.empty_cache()
    return out


class TimedRunner:
    """A scan runner whose calls are synchronized and timed per step, by the
    dataset's width."""

    def __init__(self, runner, record, width):
        self.runner, self.record, self.width = runner, record, width

    def __call__(self, state, perm, bgs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = self.runner(state, perm, bgs)
        torch.cuda.synchronize()
        self.record["ms"].setdefault(self.width, []).append(
            (time.perf_counter() - t1) * 1e3 / len(perm))
        self.record["loss"] += out[1][:, self.runner.names.index(
            "loss")].tolist()
        return out

    def __getattr__(self, name):
        return getattr(self.runner, name)


def phase_dispatch(seed, profile_dir, root, per_step):
    """(a) graph against eager chunks; (b) the room trainer through the
    graph path; (c) ``cli train --supervise`` through a killed child;
    (d) ``train-multi`` of two copies of the room."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from qed_splatter_tpu_torch import cli
    from qed_splatter_tpu_torch.configs import TrainerConfig
    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine import scan_runner
    from qed_splatter_tpu_torch.engine.journal import AttemptJournal
    from qed_splatter_tpu_torch.engine.multi_scene import MultiSceneTrainer
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase dispatch: multi-step dispatch as a CUDA graph of the step "
          f"(card: {card_state()})", flush=True)
    t_phase = time.perf_counter()
    out = {"cases": {}}
    for case in DISPATCH_CASES:
        out["cases"][case[0]] = dispatch_case(*case, seed)

    with tempfile.TemporaryDirectory() as tmp:
        # --- (b) the room trainer through the graph path
        cfg = dataclasses.replace(
            trainer_config(str(root), str(Path(tmp) / "graph"), seed),
            steps_per_dispatch=0)
        dm = FullImageDatamanager(cfg.data, seed=seed)
        trainer = Trainer(cfg, datamanager=dm)
        chunk = trainer._dispatch_chunk()
        check(trainer._use_scan() and chunk == 10,
              f"the room trainer picks multi-step dispatch, chunk {chunk}")
        record = {"ms": {}, "loss": []}
        runners = {}
        orig = trainer._get_scan_fn

        def get(*args, **kwargs):
            runner, ds = orig(*args, **kwargs)
            runners[id(runner)] = runner
            return TimedRunner(runner, record, ds.width), ds
        trainer._get_scan_fn = get
        first = trainer.eval_all(0)
        kernels = (rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.BIN_EMIT)
        for kern in kernels:
            kern.reset()
        t0 = time.perf_counter()
        trainer.train(max_steps=TRAINER_STEPS, finalize=False)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        final = trainer.eval_all(TRAINER_STEPS)
        graphs = sum(r.captures for r in runners.values())
        pool = scan_runner.pool_bytes(scan_runner.graph_pool("cuda"), "cuda")
        print(f"  (b) {TRAINER_STEPS} steps through the graph path in "
              f"{t_train:.2f} s with their refines, evals and checkpoints "
              f"(card after: {card_state()}); "
              f"{graphs} graphs captured ({len(runners)} runners), "
              f"launches {launches}; pool {pool} bytes")
        for width, ms in sorted(record["ms"].items()):
            ps = per_step["ms_per_step"].get(str(width))
            print(f"    bucket {width} px wide: {len(ms)} chunks, median "
                  f"{statistics.median(ms):.3f} ms per step (min "
                  f"{min(ms):.3f}, max {max(ms):.3f}); the per-step path "
                  f"{ps if ps is None else round(ps, 3)}")
        print(f"    eval_all psnr {first['rgb_psnr']:.3f} -> "
              f"{final['rgb_psnr']:.3f} (the per-step run "
              f"{per_step['eval_psnr'][1]:.3f}); gaussians "
              f"{final['gaussian_count']}, capacity "
              f"{trainer.state.params.capacity}, K per bucket "
              f"{trainer._k_by_d}")
        check(len(record["loss"]) == TRAINER_STEPS
              and all(math.isfinite(x) for x in record["loss"]),
              f"all {TRAINER_STEPS} graph-path losses finite")
        # the evals render too: the backward counts the steps alone
        check(rp.COMPOSITE_BWD.launches == TRAINER_STEPS
              and min(launches.values()) >= TRAINER_STEPS,
              "every kernel launched once per step, replays counted")
        check(final["rgb_psnr"] > first["rgb_psnr"], "graph path: eval PSNR "
              "rose")
        check(abs(final["rgb_psnr"] - per_step["eval_psnr"][1]) <= 1.0,
              "graph path: eval PSNR within 1.0 dB of the per-step run")
        check(len(metrics_rows(trainer.run_dir, "grow")) >= 1,
              "graph path: the capacity grew")
        idle = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            # one chunk of replays at full resolution (its graph exists)
            trainer._get_scan_fn = orig
            before = {k.symbol: k.launches for k in kernels}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                trainer.train(max_steps=TRAINER_STEPS + chunk,
                              finalize=False)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t1) * 1e3
            counted = {k.symbol: k.launches - before[k.symbol]
                       for k in kernels}
            seen = kernel_events(prof, kernels)
            print(f"    the profiled chunk: counted {counted}, the profiler "
                  f"saw {seen}")
            check(counted == seen, "graph path: the profiler saw each "
                  "counted kernel launch")
            busy_ms = sum(e.self_device_time_total for e in prof.events()
                          if e.device_type
                          == torch.autograd.DeviceType.CUDA) / 1e3
            idle = 1 - busy_ms / wall_ms
            path = f"{profile_dir}/profile_dispatch_chunk.txt"
            with open(path, "w") as f:
                f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                                  row_limit=50))
            print(f"    profile of one chunk ({chunk} steps at {W}x{H}, "
                  f"with its callbacks) written to {path}: device busy "
                  f"{busy_ms / chunk:.3f} ms per step of "
                  f"{wall_ms / chunk:.3f} ms wall (idle share {idle:.3f})")
        out["trainer"] = {
            "ms_per_step": {str(w): statistics.median(v)
                            for w, v in record["ms"].items()},
            "eval_psnr": [first["rgb_psnr"], final["rgb_psnr"]],
            "graphs": graphs, "launches": launches, "pool_bytes": pool,
            "idle_share": idle}
        del trainer, runners, orig, get
        torch.cuda.empty_cache()

        # --- (c) the supervisor through a killed child, half resolution
        half = ["--model.num-downscales", "1", "--model.resolution-schedule",
                "100000"]
        args = ["--data", str(root), "--max-num-iterations",
                str(SUPERVISED_STEPS), "--steps-per-save",
                str(SUPERVISED_SAVE), "--steps-per-eval-image", "0",
                "--steps-per-eval-all-images", "0", "--output-dir", tmp,
                "--vis", "none", "--seed", str(seed), *half]
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "qed_splatter_tpu_torch.cli", "train",
             *args, "--experiment-name", "supervised", "--supervise",
             "--max-restarts", "2"],
            env=dict(os.environ, QED_CRASH_ONCE_AT=str(SUPERVISED_CRASH)),
            capture_output=True, text=True, timeout=400)
        lines = [x for x in res.stdout.splitlines()
                 if x.startswith(("SUPERVISOR", "TEST HOOK", "Resumed",
                                  "Trained"))]
        print(f"  (c) supervised run rc {res.returncode} in "
              f"{time.perf_counter() - t0:.2f} s: {lines}")
        if res.returncode:
            print(res.stdout[-3000:] + res.stderr[-3000:])
        run_dir = Path(tmp) / "supervised"
        journal = AttemptJournal(run_dir / "attempt_journal.jsonl")
        recs = journal.records()
        latest = ckpt.latest_checkpoint(run_dir / "ckpts")
        check(res.returncode == 0 and res.stdout.count(
            "SUPERVISOR: training process exited") == 1
            and "completed after 1 restart" in res.stdout,
            "the supervised run completed after exactly one restart")
        check(f"step-{SUPERVISED_SAVE:09d}" in " ".join(
            x for x in lines if x.startswith("Resumed")),
            f"the restart resumed from step {SUPERVISED_SAVE}")
        check(latest is not None
              and latest.name == f"step-{SUPERVISED_STEPS:09d}",
              "the supervised run reached its last checkpoint")
        check(recs and not journal.crashed(), f"the journal holds "
              f"{len(recs)} records, all matched")
        out["supervisor"] = {"rc": res.returncode, "journal_records":
                             len(recs), "wall_s": time.perf_counter() - t0}

        # --- (d) train-multi: two copies of the room under two names
        scenes = []
        for name in ("roomA", "roomB"):
            (Path(tmp) / name).symlink_to(root, target_is_directory=True)
            scenes.append(str(Path(tmp) / name))
        mcfg, _ = cli.build_trainer_config(
            ["--output-dir", tmp, "--experiment-name", "multi",
             "--max-num-iterations", str(MULTI_STEPS), "--steps-per-save",
             str(MULTI_STEPS), "--steps-per-eval-image", "0",
             "--steps-per-eval-all-images", "0", "--seed", str(seed),
             *half])
        for kern in kernels:
            kern.reset()
        before = scan_runner.pool_bytes(scan_runner.graph_pool("cuda"),
                                        "cuda")
        t0 = time.perf_counter()
        mst = MultiSceneTrainer(mcfg, scenes)
        states = mst.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_scene = {name: [runner_pool_bytes(r)
                            for r in tr._runners.values()]
                     for name, tr in mst.trainers.items()}
        pool = scan_runner.pool_bytes(scan_runner.graph_pool("cuda"), "cuda")
        print(f"  (d) train-multi of {list(states)} in {wall:.2f} s: steps "
              f"{ {k: v.step for k, v in states.items()} }, launches "
              f"{ {k.symbol: k.launches for k in kernels} }; graph pool "
              f"{before} bytes before, after each scene's capture "
              f"{per_scene}, now {pool}")
        check(all(v.step == MULTI_STEPS for v in states.values())
              and all(bool(torch.isfinite(v.params.means).all())
                      for v in states.values())
              and all((Path(tmp) / "multi" / n / "splat.ply").exists()
                      for n in states),
              "train-multi completed both scenes")
        check(kernels[1].launches == 2 * MULTI_STEPS,
              "train-multi: one backward per step of each scene")
        out["multi"] = {"wall_s": wall, "pool_bytes_before": before,
                        "pool_bytes_by_scene": per_scene,
                        "pool_bytes": pool}
        del mst, states
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  dispatch phase wall time {out['wall_s']:.2f} s")
    return out

# --------------------------------------------------------- pipeline phase

PIPELINE_ORBIT_FRAMES = 8
# a CLI frame's uint8 levels against the plain path's: equal within 1 on at
# least this share of the pixels (the kernel and plain colours differ by
# rounding, which can cross a level boundary)
PIPELINE_PIXEL_SHARE = 0.999
# init-pc on the room: the share of points colorize must colour; the eval-pc
# limits of the cloud against the room's own seed cloud (both sample the
# room's surfaces, so a miss is a fault)
PIPELINE_COLORED, PIPELINE_ACC_P90, PIPELINE_COMPLETE = 0.9, 0.05, 90.0
# the room's surfaces (about 95 m^2) on a 0.05 m grid hold some 38,000 cells
PIPELINE_MIN_POINTS = 10_000
# the tests' random LPIPS widths, by torchvision feature index
LPIPS_WIDTHS = {0: 16, 2: 16, 3: 24, 5: 24, 6: 32, 7: 32, 8: 32, 10: 32,
                12: 32, 14: 32, 17: 48, 19: 48, 21: 48, 24: 48, 26: 48,
                28: 48}


def random_lpips_net(net_type, rng):
    """Seeded random LPIPS weights (convolutions, biases, heads) at narrow
    widths, as the tests make them: no pretrained weights are shipped."""
    from qed_splatter_tpu_torch.ops.lpips import _ARCH

    arch = _ARCH[net_type]
    convs, biases, heads = [], [], []
    cin = 3
    for idx, _, _ in arch["convs"]:
        cout = LPIPS_WIDTHS[idx]
        k = {(0, "alex"): 11, (3, "alex"): 5}.get((idx, net_type), 3)
        convs.append(rng.normal(0, 0.2, (cout, cin, k, k)).astype(np.float32))
        biases.append(rng.normal(0, 0.1, (cout,)).astype(np.float32))
        cin = cout
        if idx in arch["taps"]:
            heads.append(rng.uniform(0, 1, (1, cout, 1, 1)).astype(
                np.float32))
    return convs, biases, heads


def host_ms(fn, reps):
    """Mean wall ms per call of a host function over ``reps`` calls."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_cli(argv):
    """``cli.main(argv)`` in this process, so the kernels' counts see its
    launches; its printed lines are echoed (progress lines left out) and
    returned. Fails unless it exits 0."""
    import contextlib
    import io

    from qed_splatter_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip() and not line.lstrip().startswith("frame "):
            print(f"    | {line}")
    check(rc == 0, f"cli {argv[0]} exited 0")
    return text


def printed_values(text):
    """The ``name: number`` lines a CLI printed, as a dict."""
    out = {}
    for line in text.splitlines():
        k, sep, v = line.strip().partition(": ")
        if sep:
            try:
                out[k] = float(v.rstrip("%"))
            except ValueError:
                pass
    return out


def key_codes(keys):
    """[N, 3] integral cell keys (|k| < 2^20) as one int64 each."""
    k = keys.to(torch.int64) + (1 << 20)
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def hold_voxel_keys(points, core, voxel):
    """The host core's voxel grid (``core``, numpy) of ``points`` (on the
    card) against the plain version. The core keys a point by
    ``floor(p * (1 / voxel))`` in float32, ``ops/voxel.py`` (and the JAX
    package's numpy) by ``floor(p / voxel)``: the core must equal
    ``cell_means`` under its own key exactly, and the plain grid must
    equal the core's on every cell no point with two different keys
    touches; each plain centroid lies within one voxel of a core one, and
    the cell counts agree within 0.1%. (On the CPU the room's back wall
    backprojects exactly onto z = 5.2, where the keys part for all of its
    points; the card's backprojection lands off that value.)"""
    from qed_splatter_tpu_torch.ops.knn import nn_distances
    from qed_splatter_tpu_torch.ops.voxel import cell_means, voxel_downsample

    core_t = torch.as_tensor(core, device=points.device)
    inv = float(np.float32(1.0) / np.float32(voxel))
    k_core = torch.floor(points * inv)
    k_plain = torch.floor(points / voxel)
    same, _ = cell_means(points, k_core)
    e_same = max(float(nn_distances(same, core_t).max()),
                 float(nn_distances(core_t, same).max()))
    check(len(same) == len(core) and e_same <= 1e-6,
          f"the core's grid equals cell_means under its own key ({len(core)} "
          f"cells, centroids within {e_same:.1e} <= 1e-6)")
    plain, _ = voxel_downsample(points, voxel)
    differ = (k_core != k_plain).any(1)
    touched = key_codes(torch.cat([k_core[differ], k_plain[differ]]))
    untouched = ~torch.isin(key_codes(torch.unique(k_plain, dim=0)),
                            touched)
    near = nn_distances(plain, core_t)
    e_un = float(near[untouched].max()) if bool(untouched.any()) else 0.0
    out = {"points": len(points), "cells_core": len(core),
           "cells_plain": len(plain),
           "points_keys_differ": int(differ.sum()),
           "points_keys_differ_by_axis": (k_core != k_plain).sum(0).tolist(),
           "cells_touched": int(torch.unique(touched).numel()),
           "max_nearest_core_centroid": float(near.max())}
    print(f"  voxel grid of {len(points)} points at {voxel}: core "
          f"{len(core)} cells, plain {len(plain)} (difference "
          f"{len(core) - len(plain)}); {out['points_keys_differ']} points "
          f"have two keys (by axis {out['points_keys_differ_by_axis']}), "
          f"touching {out['cells_touched']} cells; a plain centroid's "
          f"nearest core centroid at most {float(near.max()):.2e}")
    check(e_un <= 1e-6, f"plain and core cells equal where no point has two "
          f"keys (within {e_un:.1e} <= 1e-6)")
    check(abs(len(core) - len(plain)) <= 1e-3 * len(plain),
          "the cell counts within 0.1%")
    check(out["max_nearest_core_centroid"] <= voxel,
          "each plain centroid has a core centroid within one voxel")
    return out


def phase_pipeline(seed, root, run_dir, work):
    """The tools a user runs before and after training, through the CLI in
    this process, on the room and the trainer phase's run: ``init-pc`` with
    the JAX package's defaults and its colorize, ``eval-pc``, ``eval`` (with
    LPIPS of seeded random nets), ``render`` in its three modes and
    ``export`` in its four forms."""
    import dataclasses

    from qed_splatter_tpu_torch import cli, native
    from qed_splatter_tpu_torch.configs import DataConfig
    from qed_splatter_tpu_torch.data import init_pc, png
    from qed_splatter_tpu_torch.data.ply import read_ply
    from qed_splatter_tpu_torch.data.transforms_json import parse_transforms
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.models.crop import CropBox
    from qed_splatter_tpu_torch.models.splatfacto import render
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles
    from qed_splatter_tpu_torch.ops.backproject import backproject_depth, \
        colorize_points
    from qed_splatter_tpu_torch.ops.knn import nn_distances
    from qed_splatter_tpu_torch.ops.lpips import LPIPS

    print(f"phase pipeline: init-pc, eval-pc, eval, render and export on "
          f"the room ({W}x{H}, {TRAINER_FRAMES} frames) and the trainer "
          f"phase's run", flush=True)
    t_phase = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    out = {}
    args = init_pc.InitPcArgs(data=str(root))          # JAX's defaults
    contents = json.loads((root / "transforms.json").read_text())
    frames = [f for f in contents["frames"] if "depth_file_path" in f]

    # --- 1. init-pc into its own file, the seed cloud left as it is
    t0 = time.perf_counter()
    run_cli(["init-pc", "--data", root, "--output-name", "init_pc.ply",
             "--no-update-transforms"])
    t_init = time.perf_counter() - t0
    cloud = read_ply(root / "init_pc.ply").positions
    print(f"  init-pc: {len(cloud)} points from {len(frames)} frames in "
          f"{t_init:.2f} s, {t_init / len(frames):.3f} s per frame (depth "
          f"decode, backprojection, the core's voxel grid, the frame's PLY)")
    check(len(cloud) > PIPELINE_MIN_POINTS,
          f"init-pc wrote a cloud of the room (> {PIPELINE_MIN_POINTS})")
    check(json.loads((root / "transforms.json").read_text()) == contents,
          "transforms.json and its ply_file_path untouched")

    f0 = frames[0]
    depth = init_pc.frame_depth(root, f0, args.depth_unit_scale_factor)
    K0 = init_pc._frame_intrinsics(contents, f0)
    c2w_cv = init_pc.frame_c2w_cv(f0)

    def backproject(d):
        return backproject_depth(d, K0, c2w_cv, args.depth_max,
                                 stride=args.stride)
    d_card = torch.as_tensor(depth, device="cuda")
    pg, vg = backproject(d_card)
    pc, vc = backproject(torch.as_tensor(depth))
    err_bp = max_abs(pg.cpu(), pc)
    check(torch.equal(vg.cpu(), vc) and err_bp <= TOL,
          f"frame 0's backprojection on the card equals the CPU's "
          f"({err_bp:.2e} <= {TOL})")
    bp_ms = cuda_ms(lambda: backproject(d_card), 20)
    pts = pg[vg].cpu().numpy()
    core_ms = host_ms(lambda: native.voxel_downsample_native(
        pts, args.frame_voxel_size), 5)
    print(f"  per frame: backprojection {bp_ms:.3f} ms on the card "
          f"({len(pts)} points at stride {args.stride}), the core's voxel "
          f"grid {core_ms:.3f} ms on the host")

    # the host core against the plain version on the final grid's input
    cached = sorted((root / "init_pc_cache" / "frames").glob("frame_*.ply"))
    merged = init_pc.streaming_merge(cached, args.merge_voxel_size,
                                     args.max_points)
    core, _ = native.voxel_downsample_native(merged, args.voxel_size)
    check(np.array_equal(core, cloud), "the CLI's cloud is the core's grid "
          "of the merged frames")
    vox = hold_voxel_keys(torch.as_tensor(merged, device="cuda"), core,
                          args.voxel_size)
    t0 = time.perf_counter()
    run_cli(["init-pc", "--data", root, "--colorize", "--input-name",
             "init_pc.ply", "--output-name", "init_pc_color.ply",
             "--no-update-transforms"])
    t_col = time.perf_counter() - t0
    colors = read_ply(root / "init_pc_color.ply").colors
    share = float((colors.astype(int).sum(-1) > 0).mean())
    check(share >= PIPELINE_COLORED,
          f"colorize coloured {share:.4f} >= {PIPELINE_COLORED} of points")
    batch = [(png.to_rgb(png.read_png(root / f["file_path"])).astype(
        np.float32) / 255.0, init_pc.frame_depth(
            root, f, args.depth_unit_scale_factor),
        init_pc.frame_w2c_opencv(f), init_pc._frame_intrinsics(contents, f))
        for f in frames[:8]]
    pos_card = torch.as_tensor(cloud, device="cuda")
    sg, cg = init_pc.colorize_batch(pos_card, batch, args)
    sc, cc = init_pc.colorize_batch(torch.as_tensor(cloud), batch, args)
    err_col = float(np.abs(sg - sc).max())
    check(np.array_equal(cg, cc) and err_col <= TOL,
          f"a colorize batch of 8 on the card equals the CPU's (counts "
          f"equal, sums {err_col:.2e} <= {TOL})")
    stacked = [torch.as_tensor(np.stack(x), device="cuda")
               for x in zip(*batch)]
    col_ms = cuda_ms(lambda: colorize_points(
        pos_card, *stacked, args.depth_max, args.depth_tolerance,
        args.depth_tolerance_rel), 10)
    col_up_ms = cuda_ms(lambda: init_pc.colorize_batch(pos_card, batch,
                                                       args), 3)
    print(f"  colorize: {share:.4f} of {len(cloud)} points coloured in "
          f"{t_col:.2f} s; a batch of 8 frames {col_ms:.3f} ms on the card, "
          f"{col_up_ms:.3f} ms with its upload from the host")
    out["init_pc"] = {
        "points": len(cloud), "s_per_frame": t_init / len(frames),
        "backproject_ms": bp_ms, "core_voxel_ms": core_ms,
        "colorize_s": t_col, "colorize_batch8_ms": col_ms,
        "colorize_batch8_with_upload_ms": col_up_ms, "colored": share,
        "voxel": vox}
    del pg, pc, d_card, stacked

    # --- 2. eval-pc of the cloud against the room's seed cloud
    gt = read_ply(root / "sparse_pc.ply").positions
    vals = printed_values(run_cli(["eval-pc", "--pred", root / "init_pc.ply",
                                   "--gt", root / "sparse_pc.ply"]))
    acc, comp = vals["accuracy_p90"], vals["completeness_0.05"]
    times = {}
    for q, r, name in ((cloud, gt, "init_pc -> sparse_pc"),
                       (gt, cloud, "sparse_pc -> init_pc")):
        d_core = native.nn_distances_native(q, r)
        qg = torch.as_tensor(q, device="cuda")
        rg = torch.as_tensor(r, device="cuda")
        d_plain = nn_distances(qg, rg).cpu().numpy()
        excess = float((np.abs(d_core - d_plain)
                        - (1e-6 + 1e-5 * np.abs(d_plain))).max())
        check(excess <= 0, f"{name}: the core's distances equal the plain "
              f"version's on the card (rtol 1e-5, atol 1e-6)")
        times[name] = (host_ms(lambda: native.nn_distances_native(q, r), 3),
                       cuda_ms(lambda: nn_distances(qg, rg), 3))
    print(f"  eval-pc: accuracy p90 {acc:.6f} m, completeness {comp:.2f}%; "
          + ", ".join(f"{k}: core {a:.2f} ms (host), plain {b:.2f} ms "
                      f"(card)" for k, (a, b) in times.items()))
    check(acc <= PIPELINE_ACC_P90 and comp >= PIPELINE_COMPLETE,
          f"accuracy p90 <= {PIPELINE_ACC_P90} m, completeness >= "
          f"{PIPELINE_COMPLETE}%")
    out["eval_pc"] = {"accuracy_p90": acc, "completeness": comp,
                      "core_ms": [a for a, _ in times.values()],
                      "plain_ms": [b for _, b in times.values()]}

    # --- 3. eval and 4. render: the main path, counted from 0
    ck = run_dir / "ckpts"
    meta = ckpt.checkpoint_meta(ck)
    want = [r for r in metrics_rows(run_dir, "eval_all")
            if r["step"] == meta["step"]][-1]
    scene = parse_transforms(DataConfig(data=str(root)))
    path_json = work / "camera_path.json"
    keys = []
    for fr in scene.frames[:4]:
        c = fr.camera
        keys.append({"camera_to_world": np.asarray(c.c2w).reshape(-1)
                     .tolist(), "fov": math.degrees(
                         2 * math.atan(c.height / (2 * c.fy)))})
    path_json.write_text(json.dumps({"render_width": W, "render_height": H,
                                     "camera_path": keys}))
    modes = {"orbit": ["--mode", "orbit", "--num-frames",
                       PIPELINE_ORBIT_FRAMES, "--width", W, "--height", H,
                       "--depth"],
             "eval": ["--mode", "eval", "--data", root],
             "path": ["--mode", "path", "--camera-path", path_json]}
    rp.COMPOSITE.reset()
    tiles.BIN_EMIT.reset()
    t0 = time.perf_counter()
    got = printed_values(run_cli(["eval", "--data", root, "--load-dir", ck,
                                  "--output-dir", work / "eval"]))
    t_eval = time.perf_counter() - t0
    wall = {}
    for mode, extra in modes.items():
        t0 = time.perf_counter()
        run_cli(["render", "--load-dir", ck, "--output-dir",
                 work / f"render_{mode}", *extra])
        wall[mode] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {"composite": rp.COMPOSITE.launches,
                "binning": tiles.BIN_EMIT.launches}
    print(f"  launches of eval and the three renders: {launches}, chunked "
          f"composite "
          f"{rp.COMPOSITE.variant_launches.get('chunked', 0)}")

    for k in ("rgb_psnr", "rgb_ssim", "depth_abs_rel"):
        print(f"  eval {k}: {got[k]:.6f}, the trainer run's eval_all at step "
              f"{meta['step']}: {want[k]:.6f}")
        check(abs(got[k] - want[k]) <= TOL, f"eval's {k} equals the trainer "
              f"run's within {TOL}")
    print(f"  eval: {t_eval:.2f} s wall for {scene.eval_indices.size} "
          f"eval frames, the checkpoint's load and the dataset's parse")

    state = ckpt.load_state(ck)
    cfg = ckpt.model_config_from_meta(meta)
    ev = scene.frames[int(scene.eval_indices[0])]
    cam = ev.camera
    pred = render(state.params, cam.c2w, cam.intrinsics_matrix(), cam.width,
                  cam.height, cfg, step=state.step).rgb
    gt_img = torch.as_tensor(png.to_rgb(png.read_png(ev.image_path)).astype(
        np.float32) / 255.0, device="cuda")
    rng = np.random.default_rng(seed)
    lp = {}
    for net in ("alex", "vgg"):
        m = LPIPS(*random_lpips_net(net, rng), net_type=net)
        v_card = float(m(pred, gt_img))
        v_cpu = float(m(pred.cpu(), gt_img.cpu()))
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        ms = cuda_ms(lambda: m(pred, gt_img), 5)
        print(f"  LPIPS ({net}, seeded random net) of eval frame 0 at "
              f"{cam.width}x{cam.height}: {v_card:.6f} on the card, "
              f"{v_cpu:.6f} on the CPU (rel {rel:.2e}), {ms:.3f} ms per "
              f"image")
        check(math.isfinite(v_card) and rel <= TOL,
              f"LPIPS ({net}) on the card equals the CPU's within {TOL}")
        lp[net] = {"value": v_card, "rel_err": rel, "ms": ms}
    out["eval"] = {"wall_s": t_eval, **{k: got[k] for k in (
        "rgb_psnr", "rgb_ssim", "depth_abs_rel")}, "lpips_random": lp}

    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    rows = {}
    for mode, extra in modes.items():
        argv = ["--load-dir", str(ck), *map(str, extra)]
        ns = cli.render_parser().parse_args(argv)
        cams = cli.render_cameras(ns, state.params)
        d = work / f"render_{mode}"
        check(len(list(d.glob("frame_*.png"))) == len(cams)
              and (mode != "orbit"
                   or len(list(d.glob("depth_*.png"))) == len(cams)),
              f"render --mode {mode} wrote {len(cams)} frames")
        c2w, K, w, h = cams[0]
        frame = png.read_png(d / "frame_00000.png")
        plain_rgb = cli.to_uint8(render(state.params, c2w, K, w, h,
                                        plain_cfg, step=state.step).rgb)
        close = float((np.abs(frame.astype(int) - plain_rgb.astype(int))
                       <= 1).all(-1).mean())
        check(frame.shape == (H, W, 3) and close >= PIPELINE_PIXEL_SHARE,
              f"render --mode {mode}: frame 0 within 1 level of the plain "
              f"path on {close:.6f} >= {PIPELINE_PIXEL_SHARE} of pixels")

        def one():
            return render(state.params, c2w, K, w, h, cfg, step=state.step)
        dev_ms = cuda_ms(one, 5)
        fr_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cli.to_uint8(one().rgb)
            fr_ms.append((time.perf_counter() - t1) * 1e3)
        enc_ms = host_ms(lambda: png.encode_png(frame), 3)
        cli_ms = wall[mode] / len(cams) * 1e3
        print(f"  render --mode {mode}: {len(cams)} frames at {w}x{h}, "
              f"{cli_ms:.1f} ms wall per frame in the CLI (checkpoint load "
              f"included); render {dev_ms:.3f} ms per frame between CUDA "
              f"events, {statistics.median(fr_ms):.3f} ms with the readback "
              f"(host clock), PNG encode {enc_ms:.1f} ms per frame")
        rows[mode] = {"frames": len(cams), "cli_ms_per_frame": cli_ms,
                      "render_ms": dev_ms,
                      "render_readback_ms": statistics.median(fr_ms),
                      "png_encode_ms": enc_ms, "within_1_level": close}
    check(launches["composite"] >= sum(r["frames"] for r in rows.values())
          and launches["binning"] >= sum(r["frames"] for r in rows.values()),
          "every CLI frame launched the compositing forward and the "
          "binning kernels")
    out["render"] = rows
    c2w, K, w, h = cli.render_cameras(cli.render_parser().parse_args(
        ["--load-dir", str(ck), *map(str, modes["orbit"])]), state.params)[0]
    entries = frame_kernel_entries(
        state.params, c2w, K, w, h, cfg, state.step,
        f"eval and render CLI, trained room, K={cfg.max_per_tile}", launches)

    # --- 5. export in its four forms
    alive = state.params.alive
    means = state.params.means[alive]
    n_alive = int(alive.sum())
    c = means.mean(0)
    half = (means.max(0).values - means.min(0).values) / 4
    box = CropBox(center=tuple(c.tolist()), size=tuple((2 * half).tolist()))
    inside = int(box.within(means).sum())
    crop = ["--crop-center", *c.tolist(), "--crop-size",
            *(2 * half).tolist()]
    exports = {"splat.ply": ([], n_alive), "splat.splat": ([], n_alive),
               "points.ply": (["--pointcloud"], n_alive),
               "crop.ply": (crop, inside)}
    for name, (extra, n) in exports.items():
        path = work / name
        run_cli(["export", "--load-dir", ck, "--output", path, *extra])
        got_n = (path.stat().st_size / 32 if name.endswith(".splat")
                 else len(read_ply(path)))
        check(got_n == n, f"export {name}: {got_n:.0f} gaussians "
              f"({n} alive{', inside the box' if extra is crop else ''})")
    check(0 < inside < n_alive, "the crop box holds a strict subset")
    out["export"] = {"alive": n_alive, "cropped": inside}
    del state, pred, gt_img
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  pipeline phase wall time {out['wall_s']:.2f} s")
    return entries, out


# ------------------------------------------------------------ codec phase

JPEG_FIXTURE = "tests/data/room_1296x840_q90.jpg"


def phase_codec(root):
    """The host core's image decoding at a dataset frame's size: a room frame
    (1296x840 RGB) written with every row Paeth and every row Average, the
    core against the plain row loops (equal samples, both timed), and the
    committed baseline JPEG (``tools/torch_jpeg_fixture.py``; the CPU tests
    hold it to PIL) through the core."""
    from qed_splatter_tpu_torch import native
    from qed_splatter_tpu_torch.data import png
    from qed_splatter_tpu_torch.data.image import decode_image

    print("phase codec: PNG unfiltering and JPEG decode in the host core",
          flush=True)
    t_phase = time.perf_counter()
    native.load()                   # the g++ build, once, outside the clock
    img = png.read_png(root / "images" / "frame_0000.png")
    out = {}
    for name, ftype in (("paeth", 4), ("average", 3)):
        data = png.encode_png(img, filter_type=ftype)
        core_s = min(host_ms(lambda: png.decode_png(data), 3) for _ in
                     range(2)) / 1e3
        got = png.decode_png(data)
        # the plain version: the same file with the core's unfilter replaced
        import zlib
        idat = b"".join(c for k, c in png._chunks(data, "x") if k == b"IDAT")
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
        t0 = time.perf_counter()
        plain = png.unfilter_plain(raw, img.shape[0], img.shape[1] * 3, 3)
        plain_s = time.perf_counter() - t0
        check(np.array_equal(got, img) and np.array_equal(
            plain.reshape(img.shape), img), f"all-{name} frame decodes to "
            "its samples on both paths")
        print(f"  {img.shape[1]}x{img.shape[0]} RGB, every row {name}: "
              f"decode_png {core_s:.4f} s (the core), the plain row loops "
              f"{plain_s:.3f} s")
        out[f"png_{name}_s"] = core_s
        out[f"png_{name}_plain_s"] = plain_s
    check(out["png_paeth_s"] < 0.1, "an all-Paeth 1296x840 frame decodes in "
          "under 0.1 s")
    data = Path(JPEG_FIXTURE).read_bytes()
    jpeg_s = min(host_ms(lambda: decode_image(data), 3)
                 for _ in range(2)) / 1e3
    got = decode_image(data)
    check(got.shape == (840, 1296, 3) and got.dtype == np.uint8,
          "the JPEG fixture decodes to 840x1296x3 uint8")
    err = float(np.abs(got.astype(np.int16) - img.astype(np.int16)).mean())
    print(f"  {JPEG_FIXTURE} ({len(data)} bytes, quality 90, 4:2:0): "
          f"{jpeg_s:.4f} s; mean |JPEG - PNG| {err:.2f} levels")
    check(err < 4.0, "the JPEG decodes to the frame it encodes")
    out["jpeg_s"] = jpeg_s
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------- forest phase

FOREST_W, FOREST_H, FOREST_FRAMES, FOREST_STEPS = 960, 540, 40, 3000
# tools/run_config4_r5.sh's flags (BASELINE config #4)
FOREST_FLAGS = ["--max-num-iterations", str(FOREST_STEPS),
                "--no-data.auto-scale-poses", "--data.center-method", "none",
                "--data.orientation-method", "none",
                "--model.random-scale", "100", "--model.num-random", "100000",
                "--log-every", "100", "--steps-per-eval-image", "200",
                "--steps-per-eval-all-images", "1500",
                "--steps-per-save", "1000", "--vis", "jsonl"]


def phase_forest(seed, work):
    """BASELINE config #4 through ``cli train --supervise``: the forest
    written by the port's writer, trained in a child process on the graph
    path, then each kernel the run launched held against its plain version
    on the forest's own inputs from the final checkpoint."""
    import dataclasses

    from qed_splatter_tpu_torch import cli, testing
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.journal import AttemptJournal
    from qed_splatter_tpu_torch.engine.train_step import make_train_step
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    print(f"phase forest: BASELINE config #4, {FOREST_W}x{FOREST_H}, "
          f"{FOREST_FRAMES} frames, {FOREST_STEPS} steps through cli train "
          f"--supervise (card: {card_state()})", flush=True)
    t_phase = time.perf_counter()
    root, out_dir = work / "forest", work / "forest_run"
    t0 = time.perf_counter()
    testing.write_forest_dataset(root, num_frames=FOREST_FRAMES,
                                 width=FOREST_W, height=FOREST_H, seed=0,
                                 eval_every=8,
                                 workers=min(8, os.cpu_count() or 1))
    t_write = time.perf_counter() - t0
    print(f"  forest written in {t_write:.2f} s")
    args = ["--data", str(root), "--output-dir", str(out_dir),
            "--experiment-name", "forest", "--seed", str(seed),
            *FOREST_FLAGS]
    # the first eval: the state the run starts from (the same seed), in
    # this process and another directory
    cfg, _ = cli.build_trainer_config(args)
    first_t = Trainer(dataclasses.replace(cfg,
                                          output_dir=str(work / "forest0")))
    first = first_t.eval_all(0)
    n0 = int(first_t.state.params.num_alive())
    del first_t
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "qed_splatter_tpu_torch.cli", "train", *args,
         "--supervise", "--max-restarts", "4"],
        capture_output=True, text=True, timeout=900)
    t_train = time.perf_counter() - t0
    (work / "forest_stdout.txt").write_text(res.stdout + res.stderr)
    if res.returncode:
        print(res.stdout[-4000:] + res.stderr[-4000:])
    check(res.returncode == 0, "the forest run exited 0")
    run = out_dir / "forest"
    lines = res.stdout.splitlines()
    k_lines = [x for x in lines if "max_per_tile" in x]
    sup = [x for x in lines if x.startswith("SUPERVISOR")]
    trained = [x for x in lines if x.startswith("Trained")]
    grow_lines = [x for x in lines if x.startswith("Growing gaussian")]
    print(f"  cli train --supervise: rc {res.returncode} in {t_train:.1f} s; "
          f"{trained}; supervisor {sup or 'no restart'}")
    for x in k_lines + grow_lines:
        print(f"    | {x}")
    rows = metrics_rows(run, "train")
    losses = [r["loss"] for r in rows] + [r.get("loss_max", 0.0)
                                          for r in rows]
    check(rows and all(math.isfinite(x) for x in losses),
          f"every loss finite ({len(rows)} train rows, each with its chunk's "
          "max)")
    evals = metrics_rows(run, "eval_all")
    marks = [("first (step 0, the seed state)", first)] + [
        (f"step {r['step']}", r) for r in evals]
    for label, e in marks:
        print(f"  eval_all {label}: psnr {e['rgb_psnr']:.3f}, ssim "
              f"{e['rgb_ssim']:.4f}, depth abs_rel {e['depth_abs_rel']:.4f},"
              f" gaussians {e['gaussian_count']}")
    last = evals[-1]
    check(last["step"] == FOREST_STEPS, f"eval_all at step {FOREST_STEPS}")
    check(last["rgb_psnr"] >= first["rgb_psnr"] + 3.0,
          "eval PSNR at the end at least 3 dB above the first eval")
    check(last["depth_abs_rel"] < first["depth_abs_rel"],
          "depth abs_rel fell")
    # ms per step: each chunk's row carries the iterations per second since
    # the previous row (its callbacks and, on a new key, its capture in)
    ips = [r["iters_per_s"] for r in rows if "iters_per_s" in r]
    ms_chunks = sorted(1e3 / x for x in ips)
    refines = metrics_rows(run, "refine")
    grows = metrics_rows(run, "grow")
    journal = AttemptJournal(run / "attempt_journal.jsonl")
    recs = journal.records()
    meta = ckpt.checkpoint_meta(run / "ckpts")
    k_by_d = {int(d): int(k) for d, k in (meta["k_by_d"] or {}).items()}
    # the bucket of the run's last steps, with the last train row's counts
    m = cfg.model
    d_last = 2 ** max(m.num_downscales
                      - (FOREST_STEPS - 1) // m.resolution_schedule, 0)
    w, h = FOREST_W // d_last, FOREST_H // d_last
    tiles_n = (-(-w // m.tile_size)) * (-(-h // m.tile_size))
    k_last = k_by_d.get(d_last, m.max_per_tile)
    bucket = {"d": d_last, "width": w, "height": h, "tiles": tiles_n,
              "k": k_last, "threshold": 0.10 * tiles_n * k_last,
              "tile_overflow": rows[-1]["tile_overflow"],
              "tile_max_count": rows[-1]["tile_max_count"]}
    launches = json.loads((run / "kernel_launches.json").read_text())
    print(f"  ms per step (median of {len(ms_chunks)} chunks of 100, "
          f"callbacks in): {statistics.median(ms_chunks):.3f} (min "
          f"{ms_chunks[0]:.3f}, max {ms_chunks[-1]:.3f})")
    print(f"  refines {len(refines)}: ms median "
          f"{statistics.median([r['ms'] for r in refines]):.2f}, max "
          f"{max(r['ms'] for r in refines):.2f}; growths "
          f"{[(r['capacity_before'], r['capacity_after'], round(r['ms'], 2)) for r in grows]}")
    print(f"  journal records {len(recs)}, crashed {journal.crashed()}; "
          f"restarts {sum('restart' in x for x in sup)}")
    b = bucket
    print(f"  final K per bucket {k_by_d}; the last bucket 1/{b['d']} "
          f"({b['width']}x{b['height']}, {b['tiles']} tiles): K {b['k']}, "
          f"last tile_overflow {b['tile_overflow']:.0f}, tile_max_count "
          f"{b['tile_max_count']:.0f}; the escalator's threshold 0.10 T K = "
          f"{b['threshold']:.0f} (overflow / threshold "
          f"{b['tile_overflow'] / b['threshold']:.4f})")
    print(f"  launches in the run's process {launches}")
    alive_end = int(last["gaussian_count"])
    check(recs and not journal.crashed(), "the journal is matched")

    # --- the kernels on the final checkpoint's own inputs
    comp = launches.get("qed_composite_tiles", {"launches": 0,
                                                "variants": {}})
    bwd = launches.get("qed_composite_tiles_bwd", {"launches": 0,
                                                   "variants": {}})
    gat = launches.get("qed_bin_emit", {"launches": 0, "variants": {}})
    check(comp["launches"] > 0 and bwd["launches"] > 0
          and gat["launches"] > 0, "the run launched composite, "
          "composite_bwd and the binning kernels")
    chunked = (comp["variants"].get("chunked", 0),
               bwd["variants"].get("chunked", 0))
    tr = Trainer(dataclasses.replace(cfg, load_dir=str(run / "ckpts"),
                                     output_dir=str(work / "forest_check")))
    k_eval = tr._k_eval(1)
    item = tr.dm.get_item(int(tr.dm.scene.eval_indices[0]))
    cam = item["camera"]
    eval_cfg = dataclasses.replace(tr.cfg, max_per_tile=k_eval)
    entries = frame_kernel_entries(
        tr.state.params, cam.c2w, cam.intrinsics_matrix(), cam.width,
        cam.height, eval_cfg, tr.state.step, f"forest eval frame, K={k_eval}",
        {"composite": comp["launches"], "binning": gat["launches"]})
    d = d_last
    k_train = tr._k_for(d)
    item = tr.dm.get_item(int(tr.dm.train_indices[0]))
    batch, tcam = tr._prepare_batch(item, d)[:2]
    step_cfg = dataclasses.replace(tr.cfg, max_per_tile=k_train)
    step = make_train_step(step_cfg, tr.optims, tcam.width, tcam.height,
                           has_depth=True)
    seed_bg = seed + 41
    with Capture(rp, "composite_tiles_bwd") as cap, \
            Capture(rp, "composite_tiles_chunked") as cap_f:
        got = step.grads(tr.state, batch, torch.Generator(
            device="cuda").manual_seed(seed_bg))
    px = tcam.width * tcam.height
    kinks = hold_grads(step_cfg, tr.optims, tcam.width, tcam.height,
                       tr.state, got, batch, seed_bg,
                       f"on the forest's final state (1/{d}, K={k_train})",
                       BWD_TOL, max_kinks={
                           "l1_sign": max(8, px // 10_000), "clamp": 8,
                           "depth_sign": max(8, px // 10_000),
                           "alpha_zero": 0})
    entries.append(bwd_entry(cap, cap_f, f"forest train step 1/{d}, "
                             f"K={k_train}", bwd["launches"]))
    past = max(k_by_d.values() or [0]) > rp.K_CHUNK
    print(f"  chunked launches in the run: composite {chunked[0]}, "
          f"composite_bwd {chunked[1]}; K "
          + ("passed" if past else "stayed at or below")
          + f" {rp.K_CHUNK}: the k_chunk variants were "
          + ("" if past else "not ") + "exercised by the training")
    if past:
        check(min(chunked) > 0, "K passed 1024 and the chunked kernels ran")
    del tr, step, got, cap, cap_f
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  forest phase wall time {wall:.2f} s")
    return entries, {
        "write_s": t_write, "train_wall_s": t_train, "rc": res.returncode,
        "eval": {label: {k: e[k] for k in ("rgb_psnr", "rgb_ssim",
                                            "depth_abs_rel")}
                 for label, e in marks},
        "alive_start": n0, "alive_end": alive_end,
        "ms_per_step_median": statistics.median(ms_chunks),
        "refine_ms": [r["ms"] for r in refines],
        "grow": [(r["capacity_before"], r["capacity_after"], r["ms"])
                 for r in grows],
        "journal_records": len(recs), "supervisor": sup,
        "k_by_d": k_by_d, "last_bucket": bucket, "k_lines": k_lines,
        "launches": launches,
        "trained_state_kinks": kinks, "wall_s": wall}


# -------------------------------------------------------- bilateral phase

BILATERAL_CHUNK, BILATERAL_STEPS = 10, 200


def bilateral_config(root, out, seed, grid):
    from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
        TrainerConfig

    model = ModelConfig(num_downscales=0, warmup_length=100, refine_every=50,
                        max_per_tile=256, use_bilateral_grid=grid)
    return TrainerConfig(max_num_iterations=BILATERAL_STEPS,
                         steps_per_eval_image=0, steps_per_eval_all_images=0,
                         steps_per_save=BILATERAL_STEPS, log_every=10,
                         output_dir=out, data=DataConfig(data=root),
                         model=model, seed=seed, steps_per_dispatch=0)


def bilateral_chunk(t, perm, label):
    """A chunk of ``len(perm)`` steps from ``t.state`` as a CUDA graph
    against the per-step loop (twice, for the eager spread): losses within
    max(1e-4, 2 * spread), grids within max(1e-5, 2 * spread)."""
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.scan_runner import make_scan_steps

    n = len(perm)
    runner = make_scan_steps(t.cfg, t.optims, t._device_dataset(1), n)
    bgs = t._backgrounds(t.state.step, n)
    state0 = ckpt.copy_state(t.state, "cuda")
    runner(ckpt.copy_state(state0, "cuda"), perm, bgs)   # the capture
    e1, losses1, eager_ms = eager_chunk(runner, ckpt.copy_state(
        state0, "cuda"), perm, bgs)
    e2, losses2, _ = eager_chunk(runner, ckpt.copy_state(state0, "cuda"),
                                 perm, bgs)
    g, rows, graph_ms_ = graph_chunk(runner, ckpt.copy_state(state0, "cuda"),
                                     perm, bgs)
    spread = max(abs(a - b) / abs(b) for a, b in zip(losses1, losses2))
    err = float(max(abs(a - b) / abs(b)
                    for a, b in zip(rows["loss"], losses1)))
    g_err = float((g.bilateral_grids - e1.bilateral_grids).abs().max())
    g_spread = float((e2.bilateral_grids - e1.bilateral_grids).abs().max())
    moved = float((e1.bilateral_grids - state0.bilateral_grids).abs().max())
    bar, g_bar = max(1e-4, 2 * spread), max(1e-5, 2 * g_spread)
    print(f"  a chunk of {n} {label}: per-step loss graph against eager "
          f"{err:.3e} (eager against eager {spread:.3e}, bar {bar:.1e}); "
          f"grids graph against eager {g_err:.3e} (eager against eager "
          f"{g_spread:.3e}, bar {g_bar:.1e}; the grids moved {moved:.3e}); "
          f"graph {graph_ms_:.3f} ms per step, eager {eager_ms:.3f}")
    check(err <= bar, f"bilateral chunk {label}: losses within the bar")
    check(g_err <= g_bar, f"bilateral chunk {label}: grids within the bar")
    check("tv_loss" in rows, "the chunk's rows carry tv_loss")
    return {"loss_rel_err": err, "eager_spread": float(spread),
            "grid_err": g_err, "grid_spread": g_spread, "grid_moved": moved,
            "graph_ms_per_step": graph_ms_, "eager_ms_per_step": eager_ms}


def phase_bilateral(seed, root, work):
    """The room at 1296x840 with ``use_bilateral_grid``: a chunk of 10
    steps as a CUDA graph against the per-step loop (losses and grids) from
    the seed state (zero moments, as every run's first chunk), 200 steps on
    the graph path with and without the grid, the same chunk check from
    the trained state, and a checkpoint round trip of the grids."""
    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.models.bilateral_grid import \
        init_bilateral_grids
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase bilateral: the room at {W}x{H} with use_bilateral_grid "
          f"(card: {card_state()})", flush=True)
    t_phase = time.perf_counter()
    out = {}
    dm = FullImageDatamanager(bilateral_config(str(root), "", seed,
                                               True).data, seed=seed)
    t = Trainer(bilateral_config(str(root), str(work / "bilateral"), seed,
                                 True), datamanager=dm)
    # from zero moments a first Adam update is lr * sign(g), which the
    # rounding of grid_sample's atomic backward can flip for a near-zero
    # gradient; the frames are those the run's first chunk trains on (put
    # back at the head of the trainer's queue)
    first = t._next_perm(BILATERAL_CHUNK)
    t._queue = first + t._queue
    out["chunk_zero_moments"] = bilateral_chunk(t, first, "from zero moments")
    torch.cuda.empty_cache()
    ms = {}
    for grid in (True, False):
        tt = t if grid else Trainer(bilateral_config(
            str(root), str(work / "bilateral_off"), seed, False),
            datamanager=dm)
        record = {"ms": {}, "loss": []}
        orig = tt._get_scan_fn

        def get(*a, _orig=orig, _rec=record, **kw):
            r, ds = _orig(*a, **kw)
            return TimedRunner(r, _rec, ds.width), ds
        tt._get_scan_fn = get
        kernels = (rp.COMPOSITE, rp.COMPOSITE_BWD, tiles.BIN_EMIT)
        for kern in kernels:
            kern.reset()
        tt.train(finalize=False)
        launches = {k.symbol: k.launches for k in kernels}
        ms[grid] = statistics.median(record["ms"][W])
        check(len(record["loss"]) == BILATERAL_STEPS
              and all(math.isfinite(x) for x in record["loss"]),
              f"{BILATERAL_STEPS} finite losses (grid {grid})")
        check(min(launches.values()) >= BILATERAL_STEPS,
              f"every kernel launched once per step (grid {grid})")
        print(f"  {BILATERAL_STEPS} steps on the graph path, grid {grid}: "
              f"median {ms[grid]:.3f} ms per step over "
              f"{len(record['ms'][W])} chunks; launches {launches}")
    # the same from the trained state: 200 steps of gradients in the
    # grids' second moments
    out["chunk"] = bilateral_chunk(t, t._next_perm(BILATERAL_CHUNK),
                                   "from the trained state")

    ident = init_bilateral_grids(t.state.bilateral_grids.shape[0],
                                 device="cuda")
    off = float((t.state.bilateral_grids - ident).abs().max())
    train_rows = metrics_rows(t.run_dir, "train")
    tv = [r["tv_loss"] for r in train_rows if "tv_loss" in r]
    print(f"  grids off identity by {off:.4e}; tv_loss logged in "
          f"{len(tv)} of {len(train_rows)} train rows (last {tv[-1]:.3e})")
    check(off > 0, "the grids left identity")
    check(len(tv) == len(train_rows) > 0, "tv_loss logged in every train row")
    back = ckpt.load_state(t.run_dir / "ckpts")
    same = torch.equal(back.bilateral_grids, t.state.bilateral_grids) and \
        all(torch.equal(back.bilateral_grid_state[k],
                        t.state.bilateral_grid_state[k])
            for k in ("count", "mu", "nu"))
    meta = ckpt.checkpoint_meta(t.run_dir / "ckpts")
    check(same and meta["use_bilateral_grid"]
          and meta["bilateral_grid_shape"] == [16, 16, 8],
          "the checkpoint restores the grids and their moments bit-equal")
    out.update({"ms_per_step_grid": ms[True], "ms_per_step_no_grid": ms[False],
                "grid_off_identity": off, "tv_rows": len(tv)})
    del t, back
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  bilateral phase wall time {out['wall_s']:.2f} s")
    return out


# ----------------------------------------------------------- viewer phase

VIEWER_STEPS = 60


def _get(url, timeout=120):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def phase_viewer(seed, root, work):
    """The room trained with ``vis="viewer"`` on the graph path while a
    client renders (once while a key is being captured), reads the status,
    the splat buffer and a camera path, and pauses and resumes training;
    then a chunk replayed under concurrent renders against the per-step
    loop, the launches one render makes, and ``cli view`` on the run's
    checkpoint."""
    import dataclasses
    import threading

    from qed_splatter_tpu_torch import cli
    from qed_splatter_tpu_torch.data import png
    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine import scan_runner
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    print(f"phase viewer: the room at {W}x{H}, {VIEWER_STEPS} steps with "
          f"vis=viewer on the graph path (card: {card_state()})", flush=True)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(
        bilateral_config(str(root), str(work / "viewer"), seed, False),
        max_num_iterations=VIEWER_STEPS, steps_per_save=VIEWER_STEPS,
        steps_per_dispatch=10, vis="viewer", viewer_port=0)
    dm = FullImageDatamanager(cfg.data, seed=seed)
    t = Trainer(cfg, datamanager=dm)
    base = f"http://127.0.0.1:{t.viewer.port}"
    capturing, sent = threading.Event(), threading.Event()
    marks = {}
    real_capture = scan_runner.ScanRunner._capture_locked

    def capture(self, state):
        # called under CAPTURE_LOCK: let the client's render arrive and
        # block on the lock before the capture starts
        capturing.set()
        sent.wait(30)
        time.sleep(0.3)
        real_capture(self, state)
        marks.setdefault("capture_end", time.perf_counter())
    scan_runner.ScanRunner._capture_locked = capture
    seen = {"renders": [], "errors": []}

    def client():
        try:
            capturing.wait(120)
            sent.set()
            t1 = time.perf_counter()
            code, body = _get(f"{base}/render?az=0.5&el=0.2&r=1.5&w=640&h=480")
            seen["during_capture"] = (t1, time.perf_counter(), code,
                                      png.decode_png(body).shape)
            # pause at once (60 steps take about a second): the gate holds
            # the loop at the next chunk's start, and the requests below
            # run while it waits
            _get(f"{base}/control?cmd=pause")
            time.sleep(1.0)            # the chunk in flight ends
            s0 = t.state.step
            for i in range(5):
                code, body = _get(f"{base}/render?az={0.3 * i}&el=0.1&r=1.5"
                                  f"&w={W}&h={H}")
                seen["renders"].append((code, png.decode_png(body).shape))
            seen["status"] = json.loads(_get(f"{base}/status")[1])
            code, body = _get(f"{base}/splats")
            seen["splats"] = (code, len(body))
            for az in (0.0, 1.0):
                _get(f"{base}/keyframe?az={az}&el=0.2&r=1.5")
            code, body = _get(f"{base}/campath?seconds=1&fps=4&w=320&h=240")
            seen["campath"] = (code, len(json.loads(body)["camera_path"]))
            time.sleep(0.5)
            seen["held"] = (s0, t.state.step)
            seen["paused_status"] = json.loads(_get(f"{base}/status")[1])
            _get(f"{base}/control?cmd=resume")
        except Exception as e:         # reported and failed below
            seen["errors"].append(repr(e))
            sent.set()
            _get(f"{base}/control?cmd=resume")

    th = threading.Thread(target=client)
    th.start()
    try:
        t.train()
    finally:
        scan_runner.ScanRunner._capture_locked = real_capture
        th.join(300)
    print(f"  client errors {seen['errors']}")
    check(not seen["errors"], "every viewer request answered")
    t1, t2, code, shape = seen["during_capture"]
    print(f"  /render sent during a capture: {code}, {shape}, answered "
          f"{(t2 - marks['capture_end']) * 1e3:.1f} ms after the capture "
          f"ended ({(t2 - t1) * 1e3:.1f} ms in all)")
    check(code == 200 and shape == (480, 640, 3)
          and t2 >= marks["capture_end"], "the render asked for during a "
          "capture waited for it and decodes to the requested size")
    check(all(c == 200 and s == (H, W, 3) for c, s in seen["renders"])
          and len(seen["renders"]) == 5, f"5 more renders at {W}x{H}")
    check(seen["status"]["training"] and seen["splats"][0] == 200
          and seen["splats"][1] > 0 and seen["campath"] == (200, 4),
          "/status, /splats and /campath answered")
    s0, s1 = seen["held"]
    print(f"  pause held the step at {s0} (after a wait {s1}); the run "
          f"ended at {t.state.step}; status {seen['status']['step']}, "
          f"{seen['status']['gaussian_count']} gaussians")
    check(s0 == s1 < VIEWER_STEPS and t.state.step == VIEWER_STEPS,
          "pause held the step between chunks, resume finished the run")
    timings = list(t.viewer.state.timings)
    r_ms = [r for r, _ in timings[1:]]
    e_ms = [e for _, e in timings[1:]]
    print(f"  /render at {W}x{H}: render {statistics.median(r_ms):.3f} ms "
          f"between CUDA events (min {min(r_ms):.3f}, max {max(r_ms):.3f}), "
          f"PNG encode {statistics.median(e_ms):.1f} ms (min {min(e_ms):.1f},"
          f" max {max(e_ms):.1f})")

    # a chunk replayed while renders run on the server threads, against the
    # per-step loop from the same state
    key = next(iter(t._runners))
    runner = t._runners[key]
    perm = t._next_perm(runner.n)
    bgs = t._backgrounds(t.state.step, runner.n)
    state0 = ckpt.copy_state(t.state, "cuda")
    stop, count = threading.Event(), [0]

    def hammer():
        while not stop.is_set():
            _get(f"{base}/render?az=1.0&el=0.2&r=1.5&w=640&h=480")
            count[0] += 1
    th = threading.Thread(target=hammer)
    th.start()
    try:
        e1, losses1, _ = eager_chunk(runner, ckpt.copy_state(state0, "cuda"),
                                     perm, bgs)
        e2, losses2, _ = eager_chunk(runner, ckpt.copy_state(state0, "cuda"),
                                     perm, bgs)
        g, rows, _ = graph_chunk(runner, ckpt.copy_state(state0, "cuda"),
                                 perm, bgs)
    finally:
        stop.set()
        th.join(120)
    spread = max(abs(a - b) / abs(b) for a, b in zip(losses1, losses2))
    err = float(max(abs(a - b) / abs(b)
                    for a, b in zip(rows["loss"], losses1)))
    bar = max(1e-4, 2 * spread)
    print(f"  a replayed chunk of {runner.n} under {count[0]} concurrent "
          f"renders: loss against the per-step loop {err:.3e} (eager spread "
          f"{spread:.3e}, bar {bar:.1e}); captures {runner.captures}")
    check(err <= bar and runner.captures == 1, "replays equal eager steps "
          "beside the viewer's renders, one capture")
    del e1, e2, g, state0

    # the launches of one render, the trainer idle
    kernels = (rp.COMPOSITE, tiles.BIN_EMIT)
    for kern in kernels:
        kern.reset()
    for _ in range(3):
        _get(f"{base}/render?az=0.2&el=0.2&r=1.5&w={W}&h={H}")
    per_render = {k.symbol: k.launches / 3 for k in kernels}
    print(f"  launches per /render {per_render}")
    check(all(v >= 1 for v in per_render.values()), "each render launched "
          "composite and the binning kernels")
    t.viewer.stop()

    # cli view on the run's checkpoint
    stop, started, rc = threading.Event(), [], []
    th = threading.Thread(target=lambda: rc.append(cli.cmd_view(
        ["--load-dir", str(t.run_dir / "ckpts"), "--port", "0"],
        stop=stop, on_start=started.append)))
    th.start()
    try:
        for _ in range(600):
            if started:
                break
            time.sleep(0.05)
        t1 = time.perf_counter()
        code, body = _get(f"http://127.0.0.1:{started[0].port}/render?az=0"
                          f"&el=0.2&r=1.5&w=640&h=480")
        view_ms = (time.perf_counter() - t1) * 1e3
        shape = png.decode_png(body).shape
    finally:
        stop.set()
        th.join(60)
    print(f"  cli view: /render {code} {shape} in {view_ms:.1f} ms; rc {rc}")
    check(code == 200 and shape == (480, 640, 3) and rc == [0],
          "cli view answered a render and stopped")
    del t, runner
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  viewer phase wall time {wall:.2f} s")
    return {"render_ms": statistics.median(r_ms),
            "png_encode_ms": statistics.median(e_ms),
            "launches_per_render": per_render, "paused_at": s0,
            "replay_loss_err": err, "cli_view_render_ms": view_ms,
            "wall_s": wall}



# ---------------------------------------------------------------- sharded

SHARDED_RANKS = 4
SHARDED_MESHES = ((2, 1), (1, 2), (2, 2))
DRY_W, DRY_H, DRY_STEPS = 512, 384, 2
LR_MEANS = 1.6e-4           # the means group's lr (default_optimizers)
SHARDED_STEPS = 200
# the trainer phase's room config, 200 steps, a train row every step and
# eval_all at the end (cli flags, so the single-device run takes the same).
# The pair budget stays put: the sharded step returns no bbox_truncated
# (as JAX's does), so a mesh never adapts it, and the single-device run
# that the meshes are held to must not either (at half resolution the
# room truncates 2,163 of 40,000 bboxes at the first log, and the single
# run doubles its budget there). Refines at 120 and 180: the eval at 200
# is not on a refine's step (a refine that splits one gaussian more or
# less places every later split child elsewhere)
SHARDED_FLAGS = ["--no-model.adaptive-pair-budget",
                 "--max-num-iterations", str(SHARDED_STEPS), "--log-every",
                 "1", "--steps-per-eval-image", "0",
                 "--steps-per-eval-all-images", str(SHARDED_STEPS),
                 "--steps-per-save", str(SHARDED_STEPS),
                 "--steps-per-dispatch", "1", "--vis", "none",
                 "--model.num-downscales", "1",
                 "--model.resolution-schedule", "200",
                 "--model.warmup-length", "100", "--model.refine-every", "60",
                 "--model.reset-alpha-every", "4",
                 "--model.init-capacity-headroom", "1.05",
                 "--model.max-per-tile", "256"]


def sharded_inputs(seed):
    """{scene: (state, batch, backgrounds, model config kwargs, width,
    height)} on the card: ``__graft_entry__.py``'s dryrun workload
    ("dry": 512x384, 65,536 / 40,000, K=256, SO3xR3, the bilateral grid,
    black, B=2), scene A (1296x840, 131,072 / 80,000, K=256, B=2) and
    scene B (327,680 / 288,000, K=2048, B=1), each of A and B with its
    scales spread and random backgrounds drawn once."""
    from qed_splatter_tpu_torch.configs import default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state
    from qed_splatter_tpu_torch.models.gaussians import init_from_points
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl

    optims = GroupOptimizers(default_optimizers())

    def batch(rng, cams, w, h):
        b = len(cams)
        return dict(
            c2w=torch.as_tensor(np.stack([c for c, _ in cams]),
                                dtype=torch.float32, device="cuda"),
            K=torch.as_tensor(np.stack([k for _, k in cams]),
                              dtype=torch.float32, device="cuda"),
            cam_idx=torch.arange(b, device="cuda"),
            rgb=torch.as_tensor(rng.uniform(0, 1, (b, h, w, 3)).astype(
                np.float32), device="cuda"),
            depth=torch.as_tensor(rng.uniform(0.5, 4.0, (b, h, w, 1)).astype(
                np.float32), device="cuda"))

    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.0, 1.0, (40_000, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.6 + 3.0
    params = init_from_points(
        pts, (rng.uniform(0, 1, (40_000, 3)) * 255).astype(np.uint8),
        capacity=65_536, device="cuda")
    k_dry = np.array([[0.9 * DRY_W, 0, DRY_W / 2], [0, 0.9 * DRY_W, DRY_H / 2],
                      [0, 0, 1]], np.float32)
    cams = [(orbit_c2w_opengl(3.0, 0.2 * i, 0.1, (0, 0, 3.0)), k_dry)
            for i in range(2)]
    out = {"dry": (init_train_state(params, optims, num_cameras=2,
                                    use_bilateral_grid=True),
                   batch(rng, cams, DRY_W, DRY_H), None,
                   dict(background_color="black", max_per_tile=256,
                        camera_opt_mode="SO3xR3", use_bilateral_grid=True),
                   DRY_W, DRY_H)}
    for label, n_alive, cap, k_cap, b in (("A", 80_000, 131_072, 256, 2),
                                          ("B", 288_000, 327_680, 2048, 1)):
        rng = np.random.default_rng(seed + 3)
        bgs = torch.rand((b, 3), generator=torch.Generator(
            device="cuda").manual_seed(seed + 5), device="cuda")
        out[label] = (spread_state(n_alive, cap, seed, optims),
                      batch(rng, cameras(2)[:b], W, H), bgs,
                      dict(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                           background_color="random"), W, H)
    return out


def sharded_cases():
    """(name, num_data, num_model, scene, steps, extra config) of the
    ranks: (a) the dryrun at 2x1, 1x2 and 2x2; (b) A at 2x2, B at 1x2 (the
    chunked kernels) and A at 2x2 with ``mixed_precision``."""
    return ([(f"dry {d}x{m}", d, m, "dry", DRY_STEPS, {})
             for d, m in SHARDED_MESHES]
            + [("A 2x2", 2, 2, "A", 1, {}), ("B 1x2", 1, 2, "B", 1, {}),
               ("A 2x2 mixed", 2, 2, "A", 1, {"mixed_precision": True})])


def sharded_counters():
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    return {"composite": rp.COMPOSITE, "composite_bwd": rp.COMPOSITE_BWD,
            "composite_mixed": rp.COMPOSITE_MIXED,
            "composite_bwd_mixed": rp.COMPOSITE_BWD_MIXED,
            "binning": tiles.BIN_EMIT}


def sharded_run(mesh, inp, steps, extra, capture=False):
    """``steps`` sharded steps of a scene on this rank's rows and cameras
    (every rank of ``mesh`` calls it): per-step losses and host ms, the
    last metrics, the launches of each kernel (counted from 0 here), the
    gathered state after the steps, and with ``capture`` the last step's
    compositing forward and backward arguments."""
    import dataclasses as dc

    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.parallel.dp import gather_state, \
        make_sharded_train_step, shard_state

    state0, batch, bgs, cfg_kw, w, h = inp
    cfg = dc.replace(ModelConfig(**cfg_kw), **extra)
    state = shard_state(ckpt.copy_state(state0, "cuda"), mesh)
    b_local = batch["rgb"].shape[0] // mesh.num_data
    lo = mesh.data_index * b_local
    local = {k: v[lo:lo + b_local] for k, v in batch.items()}
    step = make_sharded_train_step(cfg, GroupOptimizers(default_optimizers()),
                                   w, h, mesh, has_depth=True)
    counters = sharded_counters()
    for kern in counters.values():
        kern.reset()
    losses, ms, caps = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if capture and i == steps - 1:
            with Capture(rp, "composite_tiles_bwd") as cap, \
                    Capture(rp, "composite_tiles_chunked") as cap_f:
                state, metrics = step(state, local, None, backgrounds=bgs)
            caps = (cap, cap_f)
        else:
            state, metrics = step(state, local, None, backgrounds=bgs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {k: kern.launches for k, kern in counters.items()}
    launches["composite_bwd_chunked"] = counters[
        "composite_bwd"].variant_launches.get("chunked", 0)
    return dict(losses=losses, ms=ms, launches=launches, caps=caps,
                metrics={k: float(v) for k, v in metrics.items()},
                full=gather_state(state, mesh), cfg=cfg, b_local=b_local)


def sharded_result(run):
    """What the parent compares, on the CPU: losses, the first moments
    (pre-Adam gradients after one step), the statistics, the means."""
    full = run["full"]
    return dict(
        losses=run["losses"], ms=run["ms"], metrics=run["metrics"],
        mu={g: s["mu"].cpu() for g, s in full.opt_state.items()},
        camera_mu=full.camera_opt_state["mu"].cpu(),
        stats={k: getattr(full.stats, k).cpu() for k in (
            "grad_norm_sum", "vis_count", "max_radii_frac")},
        means=full.params.means.cpu(), b_local=run["b_local"])


def sharded_rank(work, num_data, num_model):
    """The body of one rank of the ``num_data x num_model`` job (gloo,
    every rank on cuda:0): the probe of gloo's collectives on CUDA tensors,
    then every case of :func:`sharded_cases` on this mesh, rank 0 writing
    each result and the kernel rows of A 2x2 and B 1x2, and every rank its
    launches."""
    import torch.distributed as dist

    from qed_splatter_tpu_torch.parallel.mesh import init_distributed, \
        make_mesh
    from qed_splatter_tpu_torch.tools.gloo_probe import probe_ops

    torch.set_num_threads(2)
    dev = init_distributed("cuda")
    rank = dist.get_rank()
    tag = f"{num_data}x{num_model}"
    try:
        out = {"probe": probe_ops(dev), "backend": dist.get_backend()}
        inputs = torch.load(f"{work}/inputs.pt", map_location=dev,
                            weights_only=False)
        mesh = make_mesh(num_data, num_model, device=dev)
        launches = {}
        for name, nd, nm, scene, steps, extra in sharded_cases():
            if (nd, nm) != (num_data, num_model):
                continue
            kernel_rows = name in ("A 2x2", "B 1x2")
            run = sharded_run(mesh, inputs[scene], steps, extra,
                              capture=kernel_rows and rank == 0)
            launches[name] = run["launches"]
            if rank == 0:
                out[name] = sharded_result(run)
                if kernel_rows:
                    out[name]["kernels"] = sharded_kernel_rows(
                        name, run, inputs[scene])
            del run
            torch.cuda.empty_cache()
        torch.save(launches, f"{work}/launches_{tag}_{rank}.pt")
        if rank == 0:
            torch.save(out, f"{work}/sharded_{tag}.pt")
    finally:
        dist.destroy_process_group()


def sharded_kernel_rows(name, run, inp):
    """The ``kernels`` rows of a sharded step's kernels on its own inputs
    (this rank's last step): the backward on its captured arguments, and the
    forward and the binning kernels on a frame of the gathered state from
    the step's first camera; ``launches`` are this rank's (the parent puts
    the sum over the ranks in their place)."""
    label = f"sharded {name}, K={run['cfg'].max_per_tile}"
    n = run["launches"]
    cap, cap_f = run["caps"]
    rows = [bwd_entry(cap, cap_f, label, n["composite_bwd"])]
    batch = inp[1]
    rows += frame_kernel_entries(
        run["full"].params, batch["c2w"][0], batch["K"][0], inp[4], inp[5],
        run["cfg"], run["full"].step, label, n)
    return rows


def sharded_reference(inputs, scene, steps, extra=None):
    """The 1x1 mesh in this process: the same steps on the same inputs."""
    from qed_splatter_tpu_torch.parallel.mesh import make_mesh

    run = sharded_run(make_mesh(1, 1, device="cuda"), inputs[scene], steps,
                      extra or {})
    return sharded_result(run)


def rel_to_max(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def hold_dry(name, got, ref):
    """(a)'s bars, ``__graft_entry__.py``'s, each reading printed beside
    its bar."""
    for i, (ls, lr) in enumerate(zip(got["losses"], ref["losses"])):
        e = abs(ls - lr) / max(1.0, abs(lr))
        print(f"  {name} step {i + 1} loss {ls:.7f} vs 1x1 {lr:.7f}: "
              f"{e:.2e} (bar 1e-4)")
        check(e <= 1e-4, f"{name} step {i + 1} loss within 1e-4 of 1x1")
    vc, vr = got["stats"]["vis_count"], ref["stats"]["vis_count"]
    n_diff = int((vc != vr).sum())
    print(f"  {name} vis_count: {n_diff} gaussians differ (bar 0)")
    check(n_diff == 0, f"{name} vis_count equal to 1x1")
    g2, w2 = got["stats"]["grad_norm_sum"], ref["stats"]["grad_norm_sum"]
    scale = max(float(w2.abs().max()), 1e-12)
    aabs = float((g2 - w2).abs().max()) / scale
    sig = w2.abs() >= 1e-2 * scale
    arel = float(((g2 - w2).abs()[sig] / w2.abs()[sig]).max())
    print(f"  {name} absgrad: abs/scale {aabs:.3e} (bar 1e-3), rel@sig "
          f"{arel:.3e} (bar 1e-2)")
    check(aabs <= 1e-3 and arel <= 1e-2, f"{name} absgrad stats")
    mx = float((got["means"] - ref["means"]).abs().max())
    print(f"  {name} updated means: max |diff| {mx:.3e} (bar "
          f"{6 * LR_MEANS:.2e} = 6 lr_means)")
    check(bool(torch.isfinite(got["means"]).all()) and mx <= 6 * LR_MEANS,
          f"{name} means within 6 lr_means of 1x1")
    return {"loss_rel": max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(
        got["losses"], ref["losses"])), "vis_count_differ": n_diff,
        "absgrad_abs_scale": aabs, "absgrad_rel_sig": arel,
        "means_max": mx}


def hold_step(name, got, ref):
    """(b)'s bars: the loss within 1e-4 relative and every pre-Adam
    gradient (mu / (1 - b1) from zero moments) within the card's step bar
    of each max."""
    from qed_splatter_tpu_torch.engine.optim import B1

    e_loss = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    errs = {g: rel_to_max(got["mu"][g] / (1 - B1), ref["mu"][g] / (1 - B1))
            for g in got["mu"]}
    errs["camera_opt"] = rel_to_max(got["camera_mu"], ref["camera_mu"])
    print(f"  {name} vs 1x1: loss {got['losses'][0]:.7f} vs "
          f"{ref['losses'][0]:.7f}, {e_loss:.2e} (bar 1e-4); gradients "
          f"(max err / max |grad|, bar {BWD_TOL}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(e_loss <= 1e-4, f"{name} loss within 1e-4 of 1x1")
    check(max(errs.values()) <= BWD_TOL,
          f"{name} gradients within {BWD_TOL} of each max")
    vis_diff = int((got["stats"]["vis_count"]
                    != ref["stats"]["vis_count"]).sum())
    check(vis_diff == 0, f"{name} vis_count equal to 1x1")
    return {"loss_rel": e_loss, "grad_max_rel": max(errs.values()),
            "grads": errs}


def phase_sharded(seed, root, work):
    """The phase "sharded": ``parallel/*`` through gloo ranks that share
    cuda:0 (the card is one; NCCL takes one card a rank). (a) the dryrun
    workload at 2x1, 1x2, 2x2 against 1x1; (b) scene A at 2x2 and B at 1x2
    against 1x1, A mixed at 2x2 against A f32 at 2x2; the kernel rows of A
    2x2 and B 1x2; (c) ``cli train`` with ``--num-model-shards 2`` and
    with ``--num-data-shards 2`` on the room against the single-device
    per-step trainer, and ``cli eval`` of rank 0's checkpoint."""
    from qed_splatter_tpu_torch import cli
    from qed_splatter_tpu_torch.parallel import launch
    from qed_splatter_tpu_torch.parallel.mesh import _ALL_GATHER, \
        _REDUCE_SCATTER

    print(f"phase sharded: one job a mesh, up to {SHARDED_RANKS} gloo "
          "ranks sharing cuda:0", flush=True)
    t_phase = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    inputs = sharded_inputs(seed)
    refs = {"dry": sharded_reference(inputs, "dry", DRY_STEPS),
            "A": sharded_reference(inputs, "A", 1),
            "B": sharded_reference(inputs, "B", 1)}
    for scene, r in refs.items():
        print(f"  {scene} at 1x1 in this process: ms per step "
              f"{[round(x, 3) for x in r['ms']]}")
    torch.save(inputs, work / "inputs.pt")
    del inputs
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    got, launches = {}, {}
    # the transport rule: gloo takes CUDA tensors for the step's three
    # collectives, so nothing is staged through a host copy
    step_ops = ("all_reduce_sum", "all_reduce_max", _ALL_GATHER.__name__,
                _REDUCE_SCATTER.__name__)
    for nd, nm in SHARDED_MESHES:
        tag = f"{nd}x{nm}"
        t0 = time.perf_counter()
        launch.spawn(launch.run_rank, nd * nm, (
            sharded_rank, nd * nm, launch.free_port(),
            (str(work), nd, nm)), timeout=600)
        t_ranks = time.perf_counter() - t0
        job = torch.load(work / f"sharded_{tag}.pt", weights_only=False)
        for r in range(nd * nm):
            for name, n in torch.load(
                    work / f"launches_{tag}_{r}.pt").items():
                tot = launches.setdefault(name, {})
                for k, v in n.items():
                    tot[k] = tot.get(k, 0) + v
        print(f"  {tag}: {nd * nm} ranks ran in {t_ranks:.1f} s; backend "
              f"{job['backend']}; gloo on CUDA tensors (probe): "
              f"{job['probe']}")
        check(job["backend"] == "gloo", f"{tag}: ranks sharing one card "
              "chose gloo")
        check(all(job["probe"][op] == "ok" for op in step_ops),
              f"{tag}: gloo runs the step's collectives "
              f"({', '.join(step_ops)}) on CUDA tensors, so nothing is "
              "staged")
        got.update(job)
    print("  transport: CUDA tensors handed to gloo as they are (gloo "
          "copies them through host memory); no collective staged")

    summary = {"backend": got["backend"], "ms_per_step_1x1": {
        scene: r["ms"] for scene, r in refs.items()},
               "transport": "CUDA tensors to gloo, none staged", "a": {},
               "b": {}, "ms_per_step": {}, "launches": launches}
    for name, nd, nm, scene, steps, extra in sharded_cases():
        r = got[name]
        n = launches[name]
        want = steps * r["b_local"] * nd * nm
        mixed = bool(extra.get("mixed_precision"))
        fwd = "composite_mixed" if mixed else "composite"
        bwd = "composite_bwd_mixed" if mixed else "composite_bwd"
        print(f"  {name}: launches {n}")
        check(n[fwd] >= want and n[bwd] == want
              and n["binning"] == want,
              f"{name}: one {fwd}, {bwd} and binning per camera "
              f"per rank ({want})")
        if scene == "B":
            check(n["composite_bwd_chunked"] == want,
                  f"{name}: the chunked backward ran")
        summary["ms_per_step"][name] = r["ms"]
        print(f"  {name}: ms per step {[round(x, 3) for x in r['ms']]} "
              "(gloo ranks sharing one card: a reading, not a speed of "
              "the design)")
        if scene == "dry":
            summary["a"][name] = hold_dry(name, r, refs["dry"])
        elif not mixed:
            summary["b"][name] = hold_step(name, r, refs[scene])
    e_mixed = abs(got["A 2x2 mixed"]["losses"][0] - got["A 2x2"]["losses"][
        0]) / abs(got["A 2x2"]["losses"][0])
    print(f"  A 2x2 mixed loss {got['A 2x2 mixed']['losses'][0]:.6f} vs f32 "
          f"{got['A 2x2']['losses'][0]:.6f}: {e_mixed:.2e} (bar 2e-2)")
    check(e_mixed <= 2e-2, "A 2x2 mixed within 2e-2 of the f32 2x2 step")
    summary["b"]["A 2x2 mixed"] = {"loss_rel_to_f32": e_mixed}
    kernels = []
    for name in ("A 2x2", "B 1x2"):
        for row in got[name]["kernels"]:
            key = row["name"].split(" (")[0]
            row["launches"] = launches[name][key]
            kernels.append(row)
    del got, refs
    torch.cuda.empty_cache()

    summary["c"] = sharded_cli(seed, root, work, cli)
    wall = time.perf_counter() - t_phase
    summary["wall_s"] = wall
    print(f"  sharded phase wall time {wall:.2f} s")
    return kernels, summary


def sharded_cli(seed, root, work, cli):
    """(c): the room through ``cli train`` at 1x2 and 2x1 (each a launcher
    process starting two ranks) against the single-device per-step trainer
    (run twice: the spread of its eval is the floor of any comparison),
    and ``cli eval`` of the 1x2 run's checkpoint. The view-parallel step
    (the JAX package's semantics, reproduced) feeds refine a weaker
    absgrad statistic than the single-device step (the norm of the
    camera-summed absgrad of loss / B, once a step, against a visibility
    count of B), so a 2x1 run densifies less at the default threshold: it
    is printed beside the single-device run, and the 2x1 bar is held on a
    pair of runs with densification held off (warm-up past the run),
    which trains the same gaussians on both sides."""
    from qed_splatter_tpu_torch.engine.trainer import Trainer

    base = ["--data", str(root), "--output-dir", str(work), "--seed",
            str(seed), *SHARDED_FLAGS]
    no_refine = ["--model.warmup-length", str(10 * SHARDED_STEPS)]
    secs = {}
    for name, extra in (("single", []), ("single2", []),
                        ("single_fixed", no_refine)):
        cfg, device = cli.build_trainer_config([*base, "--experiment-name",
                                                name, *extra])
        t0 = time.perf_counter()
        Trainer(cfg, device=device).train()
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    for name, extra in (("m2", ["--num-model-shards", "2"]),
                        ("d2", ["--num-data-shards", "2"]),
                        ("d2_fixed", ["--num-data-shards", "2",
                                      *no_refine])):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "qed_splatter_tpu_torch.cli", "train",
             *base, "--experiment-name", name, *extra],
            capture_output=True, text=True, timeout=600)
        secs[name] = time.perf_counter() - t0
        (work / f"{name}_stdout.txt").write_text(res.stdout + res.stderr)
        lines = [x for x in res.stdout.splitlines()
                 if x.startswith(("mesh", "Trained", "Growing gaussian"))]
        print(f"  cli train {' '.join(extra)}: rc {res.returncode} in "
              f"{secs[name]:.1f} s: {lines}")
        if res.returncode:
            print(res.stdout[-3000:] + res.stderr[-3000:])
        check(res.returncode == 0, f"cli train {' '.join(extra)} exited 0")
    rows = {k: metrics_rows(work / k, "train") for k in secs}
    evals = {k: metrics_rows(work / k, "eval_all")[-1] for k in secs}
    refine = {k: [(r["step"], r["n_alive"], r["n_split"], r["n_dup"])
                  for r in metrics_rows(work / k, "refine")] for k in secs}
    ms = {k: secs[k] / SHARDED_STEPS * 1e3 for k in secs}
    for k in secs:
        print(f"  {k}: refines (step, alive, split, dup) {refine[k]}; last "
              f"loss {rows[k][-1]['loss']:.5f}; eval {evals[k]['rgb_psnr']:.3f}"
              f" dB, {evals[k]['gaussian_count']} gaussians")
    first = [abs(b["loss"] - a["loss"]) / abs(a["loss"])
             for a, b in zip(rows["single"][:10], rows["m2"][:10])]
    print(f"  1x2 against single, first 10 losses: max relative "
          f"{max(first):.2e} (bar 1e-4)")
    check(len(first) == 10 and max(first) <= 1e-4,
          "1x2's first 10 losses within 1e-4 of the single-device run")
    # the first refine's bar; later refines part by the single run's own
    # spread (its backward's atomics), printed beside them
    counts = [(a[0], a[1], b[1], c[1]) for a, b, c in zip(
        refine["single"], refine["m2"], refine["single2"])]
    print(f"  gaussians after each refine (step, single, 1x2, single "
          f"again): {counts}")
    check(counts and len(refine["single"]) == len(refine["m2"])
          and abs(counts[0][2] - counts[0][1]) <= 1e-3 * counts[0][1],
          "1x2's gaussian count after the first refine within 0.1% of "
          "single")
    psnr = {k: e["rgb_psnr"] for k, e in evals.items()}
    # the single-device run's eval parts from run to run by up to 0.2 dB
    # (the backward's atomics move which gaussians the refines split; two
    # eval frames): 1x2 is held to the mean of its two runs
    single = (psnr["single"] + psnr["single2"]) / 2
    print(f"  eval PSNR at {SHARDED_STEPS}: {psnr} (single twice: spread "
          f"{abs(psnr['single'] - psnr['single2']):.3f} dB; 1x2 "
          f"{psnr['m2'] - single:+.3f} dB of their mean, bar 0.3)")
    check(abs(psnr["m2"] - single) <= 0.3,
          "1x2's eval PSNR within 0.3 dB of single's")
    # the bar of 2x1, at most 1.0 dB under single, on the default config:
    # the view-parallel step (the JAX package's, which the port's 2x1
    # trainer equals through a refine:
    # tests/test_torch_parallel_trainer.py) densifies less, so the reading
    # stands beside the bar and PERF.md gives its cause; the bar is held
    # on the pair of runs with densification held off
    d2_gap = psnr["d2"] - single
    print(f"  2x1 with densification (the default config): {d2_gap:+.3f} "
          f"dB against single, bar -1.0 dB: "
          + ("met" if d2_gap >= -1.0 else "missed (the reference's "
             "view-parallel densify statistic; PERF.md, PR 12)"))
    print(f"  2x1 with densification held off on both: "
          f"{psnr['d2_fixed'] - psnr['single_fixed']:+.3f} dB against "
          f"single, bar -1.0 dB")
    check(psnr["d2_fixed"] >= psnr["single_fixed"] - 1.0,
          "2x1's eval PSNR at most 1.0 dB under single (densification "
          "held off on both)")
    # rank 0's checkpoint, read by a single-device cli eval
    got = printed_values(run_cli(["eval", "--data", root, "--load-dir",
                                  work / "m2" / "ckpts", "--output-dir",
                                  work / "m2_eval"]))
    diffs = {k: abs(got[k] - evals["m2"][k]) for k in (
        "rgb_psnr", "rgb_ssim", "depth_abs_rel")}
    print(f"  cli eval of the 1x2 checkpoint against the run's eval_all: "
          f"{diffs} (bar 1e-4)")
    check(all(v <= 1e-4 for v in diffs.values()),
          "cli eval of rank 0's checkpoint equals the run's own eval")
    launched = json.loads((work / "m2" / "kernel_launches.json").read_text())
    print(f"  1x2 rank 0's launches: {launched}")
    check(all(launched.get(sym, {}).get("launches", 0) >= SHARDED_STEPS
              for sym in ("qed_composite_tiles", "qed_composite_tiles_bwd",
                          "qed_bin_emit")),
          "rank 0 of the 1x2 run launched each kernel of the step at least "
          "once a step")
    for name in secs:
        print(f"  {name}: {ms[name]:.1f} ms per step (the run's wall over "
              f"{SHARDED_STEPS} steps, start-up, refines and eval in; gloo "
              "ranks sharing one card: a reading, not a speed of the design)")
    return {"psnr": psnr, "first_losses_max_rel": max(first),
            "refines": refine, "eval_diffs": diffs, "ms_per_step_wall": ms,
            "rank0_launches": {k: v["launches"] for k, v in launched.items()}}


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
    with ThreadPoolExecutor(2) as pool:     # every nvcc at once
        jobs = [pool.submit(qcuda.build, qcuda.sources()),
                pool.submit(qcuda.build, ["composite", "composite_bwd"],
                            WITNESS_DEFINES)]
        secs = max(j.result() for j in jobs)
    print(f"  built {qcuda.sources()} and composite, composite_bwd "
          f"{WITNESS_DEFINES} in {secs:.2f} s")
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
    kernels, binning = phase_binning(args.seed)
    frames, steps = {}, {}
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

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "room"
        t_data = write_room(root)
        trainer = phase_trainer(args.seed, args.profile, root, t_data,
                                Path(tmp) / "trainer")
        dispatch = phase_dispatch(args.seed, args.profile, root, trainer)
        entries, pipeline = phase_pipeline(
            args.seed, root, Path(tmp) / "trainer" / "qed-splatter",
            Path(tmp) / "pipeline")
        kernels += entries
        codec = phase_codec(root)
        bilateral = phase_bilateral(args.seed, root, Path(tmp))
        viewer = phase_viewer(args.seed, root, Path(tmp))
        entries, forest = phase_forest(args.seed, Path(tmp))
        kernels += entries
        entries, sharded = phase_sharded(args.seed, root,
                                         Path(tmp) / "sharded")
        kernels += entries
    print(json.dumps({"render_ms_per_frame": frames,
                      "train_ms_per_step": steps, "bench": bench_line,
                      "trainer": trainer, "dispatch": dispatch,
                      "pipeline": pipeline, "codec": codec,
                      "bilateral": bilateral, "viewer": viewer,
                      "forest": forest, "sharded": sharded,
                      "binning": binning}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
