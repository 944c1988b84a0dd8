#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``qed_splatter_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases (any failure exits non-zero):
1. build every CUDA kernel under ``qed_splatter_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on seeded random
   inputs at the render path's shapes;
3. scene A (the bench's canonical point): 131,072 capacity / 80,000 alive,
   SH degree 3, K = 256, 1296x840, 4 orbit cameras through
   ``render(train=False)``;
4. scene B (the adaptive-K dense regime): 327,680 / 288,000, K = 2048,
   2 cameras, which takes the compositor's chunked path.

Each scene resets the kernels' launch counts, renders, and fails unless every
kernel launched; checks finite outputs of the right shape; matches one frame
against the plain path (``use_pallas=False``) on the card; holds each kernel
against its plain version on that frame's inputs; and times the frame, each
kernel, its plain version and its bound.

Prints a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
REPLACES = {
    "composite": ("qed_splatter_tpu/ops/rasterize_pallas.py:231 _fwd_kernel; "
                  "qed_splatter_tpu/ops/rasterize_pallas.py:241 "
                  "_fwd_kernel_skip"),
    "slab_gather": "qed_splatter_tpu/ops/tiles.py:67 _slab_kernel",
}
SOURCES = {"composite": "qed_splatter_tpu_torch/csrc/composite.cu",
           "slab_gather": "qed_splatter_tpu_torch/csrc/slab_gather.cu"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2

def random_slabs(gen, t, k, d, counts, num_tiles_x, saturate=None):
    """Channel-major slabs of plausible splats around each tile; slots at or
    past ``counts[t]`` are padding (opacity 0), as the binning leaves them."""
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
        means[saturate, :, :8] = torch.stack([ox, oy], 1)[saturate] + 8.0
        conics[saturate, 0, :8] = 1e-6
        conics[saturate, 1, :8] = 0.0
        conics[saturate, 2, :8] = 1e-6
        opac[saturate, :8] = 0.999
    return [x.contiguous() for x in (means, conics, colors, opac[:, None])]


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

    k = 2048
    counts = torch.randint(1, k + 1, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[: t // 3] = torch.randint(1, rp.K_CHUNK + 1, (t // 3,),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
    saturate = torch.zeros(t, dtype=torch.bool, device="cuda")
    saturate[t // 3: t // 2] = True
    counts[saturate] = k
    slabs = random_slabs(gen, t, k, 4, counts, ntx, saturate)
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
    starts[:4] = torch.tensor([0, m, m + 5, -3], device="cuda")
    got = tiles.slab_gather(keys, starts, 256, -1)
    want = tiles.slab_gather_ref(keys, starts, 256, -1)
    check(torch.equal(got, want), "slab_gather K=256 exact (starts 0, M, "
          "past M, negative)")
    torch.cuda.synchronize()


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
    print(f"  launches {launches}, chunked composite launches {chunked}")
    check(all(v >= n_cams for v in launches.values()),
          "every kernel launched on the main path")
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
            Capture(tiles, "slab_gather") as cap_g:
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

    keys, starts, kk, fill = cap_g.args
    got = tiles.slab_gather(keys, starts, kk, fill)
    want = tiles.slab_gather_ref(keys, starts, kk, fill)
    check(torch.equal(got, want), "slab_gather on frame inputs exact")

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

    ms_c = cuda_ms(lambda: rp.composite_tiles_chunked(
        *g_args, tile_counts=counts), 20)
    plain_c = cuda_ms(lambda: rp.composite_tiles_ref(
        *g_args, tile_counts=counts, k_chunk=k_chunk), 2)
    in_bytes = sum(x.numel() * 4 for x in g_args[:4]) + counts.numel() * 4
    out_bytes = (out.numel() + acc.numel()) * 4
    needed = torch.minimum(torch.minimum(counts.long(), torch.tensor(
        k, device="cuda")), runs.long() * (k_chunk or k))
    ops = 256 * int(needed.sum()) * (20 + 2 * d)
    b_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_F32_PER_S * 1e3

    m = keys.numel()
    ms_g = cuda_ms(lambda: tiles.slab_gather(keys, starts, kk, fill), 50)
    plain_g = cuda_ms(lambda: tiles.slab_gather_ref(keys, starts, kk, fill),
                      20)
    padded = torch.cat([keys, torch.full((kk,), fill, dtype=keys.dtype,
                                         device="cuda")])
    windows = padded.unfold(0, kk, 1)              # a view, no copy
    st = starts.clamp(0, m)
    lib_g = cuda_ms(lambda: torch.index_select(windows, 0, st), 50)
    g_bytes = (m + starts.numel() + starts.numel() * kk) * 8
    print(f"  composite {ms_c:.4f} ms (plain {plain_c:.3f} ms), "
          f"slab_gather {ms_g:.4f} ms (plain {plain_g:.4f}, index_select "
          f"{lib_g:.4f} ms)")

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

    entries = []
    for name, ms, plain_ms, lib, bound_b, bound_o, err in (
        ("composite", ms_c, plain_c, None, b_bytes, b_ops, err_abs),
        ("slab_gather", ms_g, plain_g, lib_g,
         g_bytes / PEAK_BYTES_PER_S * 1e3, 0.0, 0.0),
    ):
        entries.append({
            "name": f"{name} (scene {label}, K={k_cap})",
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_b, bound_o),
            "bound_by": "operations" if bound_o > bound_b else "bytes",
            "library_ms": lib,
        })
    del outs, plain, params
    torch.cuda.empty_cache()
    return entries, frame_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler tables of each scene")
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"  card: {smi}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernel_parity(gen)
    kernels, frames = [], {}
    for label, n_alive, cap, k_cap, n_cams, reps in (
        ("A", 80_000, 131_072, 256, 4, 3),
        ("B", 288_000, 327_680, 2048, 2, 2),
    ):
        entries, frame_ms = phase_scene(label, n_alive, cap, k_cap, n_cams,
                                        reps, args.seed, args.profile)
        kernels += entries
        frames[label] = frame_ms

    print(json.dumps({"render_ms_per_frame": frames}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
