"""The port's benchmark: training-step throughput on the GPU (port of
``bench.py``).

    python -m qed_splatter_tpu_torch.bench [--device cuda] [--seed 0]

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``,
``unit``, ``vs_baseline`` and ``extra``. It measures the whole step of
``engine.train_step.make_train_step`` (project -> SH -> bin -> the
compositing kernels -> loss -> backward -> per-group Adam and camera Adam ->
absgrad stats) at ``bench.py``'s three points, on ``bench.py``'s scene:

- canonical (the headline): 131,072 capacity / 80,000 alive, one 1296x840
  camera per step, K = 256;
- dense (``extra``): 327,680 / 288,000, K = 1024, 10 timed steps;
- the canonical point with ``mixed_precision`` (the bf16 operand
  compositing kernels; ``extra``).

Timing: ``n_timed`` warm-up steps, then ``n_timed`` steps between two
``torch.cuda.synchronize()`` calls, wall time / ``n_timed``: the per-step
loop users run today, host launches included (the JAX bench times one
``fori_loop`` dispatch; eager PyTorch has no such loop yet).

``vs_baseline`` = iters/s / 30, the reference GPU stack's rate on an
A100-class card that ``bench.py`` names (the reference's figure, not
measured here). ``extra.device`` is the card's name and power limit
(``nvidia-smi``). The bench holds the GPU lock (``utils/chiplock.py``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from qed_splatter_tpu_torch import resolve_device

REFERENCE_ITERS_PER_S = 30.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(width, height, capacity, n_alive, k_cap, mixed_precision,
            n_timed=20, seed=0, device="cuda"):
    """(iters/s, loss finite) of one workload point; fresh state per call.
    The scene is ``bench.py``'s: the same numpy draws in the same order."""
    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.models.gaussians import init_from_points
    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n_alive, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.7 + 3.0
    rgb = (rng.uniform(0, 1, (n_alive, 3)) * 255).astype(np.uint8)
    params = init_from_points(pts, rgb, capacity=capacity, device=dev)

    cfg = ModelConfig(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                      background_color="random",
                      mixed_precision=mixed_precision)
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(params, optims, num_cameras=4)
    step = make_train_step(cfg, optims, width, height, has_depth=True,
                           device=dev)

    f = 0.85 * max(width, height)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    c2w = orbit_c2w_opengl(3.0, 0.15, 0.1, (0, 0, 3.0))
    gt_rgb = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    gt_depth = rng.uniform(0.5, 4.0, (height, width, 1)).astype(np.float32)
    batch = dict(c2w=torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                 K=torch.as_tensor(K, device=dev), cam_idx=0,
                 rgb=torch.as_tensor(gt_rgb, device=dev),
                 depth=torch.as_tensor(gt_depth, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)

    for _ in range(n_timed):                       # warm-up
        state, _ = step(state, batch, gen)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, _ = step(state, batch, gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    assert state.step == 2 * n_timed

    # loss sanity from one more step
    _, metrics = step(state, batch, gen)
    loss = float(metrics["loss"])
    return n_timed / dt, math.isfinite(loss)


def device_name(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them (the
    device itself off the GPU)."""
    if resolve_device(device).type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def run(device="cuda", seed=0, width=1296, height=840, n_timed=20,
        dense_n_timed=10, points=None) -> dict:
    """``bench.py``'s three points; the bench line as a dict. ``points``
    (capacity, alive, K of the canonical and the dense point) and the sizes
    shrink it for a rehearsal."""
    canon, dense = points or ((131_072, 80_000, 256), (327_680, 288_000,
                                                       1024))
    iters, finite = measure(width, height, *canon, False, n_timed, seed,
                            device)
    dense_iters, dense_finite = measure(width, height, *dense, False,
                                        dense_n_timed, seed, device)
    mp_iters, mp_finite = measure(width, height, *canon, True, n_timed,
                                  seed, device)
    mpix = iters * width * height / 1e6
    return {
        "metric": "train_iters_per_s_1296x840_80k_gaussians",
        "value": round(iters, 3),
        "unit": "iters/s",
        "vs_baseline": round(iters / REFERENCE_ITERS_PER_S, 3),
        "extra": {
            "rasterized_mpix_per_s": round(mpix, 2),
            "device": device_name(device),
            "loss_finite": finite and dense_finite and mp_finite,
            "dense_288k_alive_k1024_iters_per_s": round(dense_iters, 3),
            "mixed_precision_iters_per_s": round(mp_iters, 3),
        },
    }


def main(argv=None) -> int:
    from qed_splatter_tpu_torch.utils.chiplock import acquire_chip_lock

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # one client on the GPU at a time: a second one skews every time taken
    acquire_chip_lock("qed_splatter_tpu_torch.bench", device=dev)
    print(json.dumps(run(args.device, args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
