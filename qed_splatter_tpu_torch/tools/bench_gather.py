"""Gather formulations of the binning and slab hot path, timed on the GPU
(port of ``tools/bench_gather.py``).

    python -m qed_splatter_tpu_torch.tools.bench_gather [--device cuda]

Each formulation the JAX tool times has its PyTorch counterpart under the
same name, at the same shapes (131,072 gaussians, 4,293 tiles of 1296x840,
K = 256, 1,507,328 sorted pair keys, 11 channels): the row gathers (f32,
bf16, 16 channels, a 2-D index), ``take`` with clip, the per-channel gather,
the slab gather as an index gather (``slab_xla``, the JAX ``lax.gather`` with
its clip), through aligned 128-blocks (``slab_aligned_take``) and through the
hand-written kernel (``slab_pallas_dma``: ``csrc/slab_gather.cu`` on 4-byte
keys, the port of the JAX tool's Pallas DMA kernel, with its plain version
and ``index_select`` on an ``unfold`` view beside it), ``searchsorted`` and
the two-level search, sorts with 1, 2 and 5 operands, and the scatter-add as
``index_add_``. The pair keys are int32 (the JAX tool's uint32 values are
below 2^31).

Times are device milliseconds per call from ``utils/microbench.py`` (CUDA
graph replays; ``eager`` beside a name that could not be captured). Holds
the GPU lock; prints one line per formulation and ONE JSON dict at the end.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

N = 131_072           # capacity
T_TILES = 4293        # 81 x 53 tiles at 1296x840
K_CAP = 256
M_PAIRS = 1_507_328   # 131072 * 8 + 8192 * 56
C = 11


def slab_inputs(rng, device):
    """(sorted int32 pair keys [M], int64 window starts [T]), the JAX tool's
    next draws from ``rng``."""
    pairs = np.sort(rng.integers(0, 2 ** 31, M_PAIRS).astype(np.uint32))
    starts = np.sort(rng.integers(0, M_PAIRS - K_CAP, T_TILES))
    return (torch.as_tensor(pairs.astype(np.int32), device=device),
            torch.as_tensor(starts.astype(np.int64), device=device))


def slab_case(device):
    """The slab inputs exactly as :func:`run` draws them (after its row
    gathers' draws from one generator seeded 0)."""
    rng = np.random.default_rng(0)
    rng.uniform(-1, 1, (N, C))
    rng.uniform(-1, 1, (N, 16))
    rng.integers(0, N, T_TILES * K_CAP)
    rng.permutation(N)
    return slab_inputs(rng, device)


def slab_library(pairs, starts, k=K_CAP):
    """The slab gather as one library call: ``index_select`` of the
    windows of an ``unfold`` view (no copy), starts within [0, M - k]."""
    return torch.index_select(pairs.unfold(0, k, 1), 0, starts)


def run(device="cuda", n_calls=20, log=print) -> dict:
    """{formulation: ms per call} (and ``<name>:eager`` for those timed
    without a graph)."""
    from qed_splatter_tpu_torch.ops import tiles
    from qed_splatter_tpu_torch.utils import microbench

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    times = {}

    def t(name, op, args, n=n_calls):
        if dev.type == "cuda":
            ms = microbench.device_time_per_call(op, args, n=n) * 1e3
            method = microbench.last_method
        else:                        # a rehearsal: one call, no time
            op(*args)
            ms, method = float("nan"), "cpu"
        times[name] = ms
        if method == "eager":
            times[f"{name}:eager"] = True
        log(f"{name} {ms:.4f} ms ({method})")

    params = torch.as_tensor(rng.uniform(-1, 1, (N, C)).astype(np.float32),
                             device=dev)
    params16 = torch.as_tensor(
        rng.uniform(-1, 1, (N, 16)).astype(np.float32), device=dev)
    idx_big = torch.as_tensor(
        rng.integers(0, N, T_TILES * K_CAP).astype(np.int64), device=dev)
    perm = torch.as_tensor(rng.permutation(N).astype(np.int64), device=dev)

    # --- row gathers
    t("row_gather_perm_c11", lambda p, i: p[i], (params, perm))
    t("row_gather_1p1M_c11", lambda p, i: p[i], (params, idx_big))
    t("row_gather_1p1M_c11_bf16", lambda p, i: p[i],
      (params.to(torch.bfloat16), idx_big))
    t("row_gather_1p1M_c16", lambda p, i: p[i], (params16, idx_big))
    t("row_gather_1p1M_c11_2d", lambda p, i: p[i.reshape(T_TILES, K_CAP)],
      (params, idx_big))
    t("take_1p1M_c11",
      lambda p, i: torch.index_select(p, 0, i.clamp(0, N - 1)),
      (params, idx_big))
    params_t = params.t().contiguous()
    t("chan_gather_1p1M",
      lambda pt, i: torch.stack([pt[ch][i] for ch in range(C)], 0),
      (params_t, idx_big))

    # --- slab slice gather (contiguous K windows at dynamic starts)
    pairs, starts = slab_inputs(rng, dev)
    lane = torch.arange(K_CAP, device=dev)

    def slab_xla(ps, st):
        # lax.gather's CLIP mode: the window start clamped into [0, M - K]
        return ps[st.clamp(0, ps.shape[0] - K_CAP)[:, None] + lane]

    t("slab_xla", slab_xla, (pairs, starts))
    three = torch.arange(3, device=dev)

    def slab_aligned(ps, st):
        ps2 = ps.reshape(-1, 128)
        rows = three[None, :] + (st // 128)[:, None]
        wide = ps2[rows].reshape(T_TILES, 3 * 128)
        return torch.gather(wide, 1, (st % 128)[:, None] + lane)

    t("slab_aligned_take", slab_aligned, (pairs, starts))
    t("slab_pallas_dma", lambda ps, st: tiles.slab_gather(ps, st, K_CAP, 0),
      (pairs, starts))
    t("slab_pallas_dma_plain",
      lambda ps, st: tiles.slab_gather_ref(ps, st, K_CAP, 0), (pairs, starts))
    t("slab_pallas_dma_library", slab_library, (pairs, starts))

    # --- searchsorted boundaries vs two-level
    queries = torch.as_tensor(
        (np.arange(T_TILES + 1) * (2 ** 31 // T_TILES)).astype(np.int32),
        device=dev)
    t("searchsorted_4k_of_1p5M",
      lambda ps, q: torch.searchsorted(ps, q, side="left"), (pairs, queries))

    def two_level(ps, q):
        s = ps[::128].contiguous()
        blk = torch.clamp(torch.searchsorted(s, q, side="left") - 1, min=0)
        wide = ps.reshape(-1, 128)[blk]
        return blk * 128 + (wide < q[:, None]).sum(1)

    t("boundaries_two_level", two_level, (pairs, queries))

    # --- sort cost with extra value operands
    keys = torch.as_tensor(rng.integers(0, 2 ** 31, M_PAIRS).astype(np.int32),
                           device=dev)
    vals = [torch.as_tensor(rng.uniform(0, 1, M_PAIRS).astype(np.float32),
                            device=dev) for _ in range(4)]
    t("sort_1op", lambda k: torch.sort(k).values, (keys,))

    def sort_with(k, *vs):
        srt, order = torch.sort(k)
        return (srt, *(v[order] for v in vs))

    t("sort_2op", sort_with, (keys, vals[0]))
    t("sort_5op", sort_with, (keys, *vals))

    # --- scatter-add of the 1.1M slot rows to 131k gaussians (context)
    rows_g = torch.as_tensor(
        rng.uniform(-1, 1, (T_TILES * K_CAP, C)).astype(np.float32),
        device=dev)
    t("scatter_add_1p1M_c11",
      lambda r, i: torch.zeros((N, C), device=dev).index_add_(0, i, r),
      (rows_g, idx_big), n=5)
    return times


def main(argv=None) -> int:
    from qed_splatter_tpu_torch import resolve_device
    from qed_splatter_tpu_torch.utils.chiplock import acquire_chip_lock

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    acquire_chip_lock("tools.bench_gather", device=dev)
    times = run(dev, log=lambda s: print(s, flush=True))
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in times.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
