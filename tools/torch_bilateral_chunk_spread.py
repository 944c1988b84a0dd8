#!/usr/bin/env python3
"""How far a chunk of bilateral-grid training steps replayed as a CUDA graph
departs from the per-step loop, against how far two per-step runs depart
from each other, over several runs.

    python3 tools/torch_bilateral_chunk_spread.py [--seed 0] [--runs 6]
                                                  [--out FILE.json]

``chip_smoke.py``'s bilateral phase holds one graph chunk of 10 steps
against one per-step run, with twice what two per-step runs differ by as
its bar (at least 1e-5 in the grids). The grids' gradients come from
``grid_sample``'s backward, which sums with atomics, so every run differs
in rounding; from zero Adam moments an update is about lr * sign(g), and a
gradient within rounding of zero can take either sign. This script writes
the room at 1296x840, and from the seed state (zero moments, on the frames
the run's first chunk trains on) and again after 200 trained steps runs
the chunk ``--runs`` times per-step and ``--runs`` times as a graph. It
prints, per state, the largest grid difference of every per-step pair and
of every graph/per-step pair, the cells that differ by more than 1e-5, and
the grids' first Adam moments (relative to their max), which carry the
gradients without the sign's amplification.

One JSON line per state. Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qed_splatter_tpu_torch import cuda as qcuda  # noqa: E402


def spread(t, perm, runs):
    """Grid and first-moment differences of ``runs`` per-step and ``runs``
    graph chunks from ``t.state``."""
    from qed_splatter_tpu_torch.engine.checkpoint import copy_state
    from qed_splatter_tpu_torch.engine.scan_runner import make_scan_steps

    n = len(perm)
    runner = make_scan_steps(t.cfg, t.optims, t._device_dataset(1), n)
    bgs = t._backgrounds(t.state.step, n)
    state0 = copy_state(t.state, "cuda")
    runner(copy_state(state0, "cuda"), perm, bgs)        # the capture
    eager, graph = [], []
    for _ in range(runs):
        e, _, _ = chip_smoke.eager_chunk(runner, copy_state(state0, "cuda"),
                                         perm, bgs)
        g, _, _ = chip_smoke.graph_chunk(runner, copy_state(state0, "cuda"),
                                         perm, bgs)
        eager.append(e)
        graph.append(g)

    def grid_diff(a, b):
        d = (a.bilateral_grids - b.bilateral_grids).abs()
        return float(d.max()), int((d > 1e-5).sum())

    def mu_diff(a, b):
        mu_a = a.bilateral_grid_state["mu"]
        mu_b = b.bilateral_grid_state["mu"]
        return float((mu_a - mu_b).abs().max()) / max(
            float(mu_b.abs().max()), 1e-30)

    ee = [grid_diff(a, b) for a, b in itertools.combinations(eager, 2)]
    ge = [grid_diff(g, e) for g in graph for e in eager]
    return {
        "step": int(state0.step), "steps": n, "runs": runs,
        "grid_moved": float((eager[0].bilateral_grids
                             - state0.bilateral_grids).abs().max()),
        "eager_eager_max": [d for d, _ in ee],
        "eager_eager_cells_over_1e-5": [c for _, c in ee],
        "graph_eager_max": [d for d, _ in ge],
        "graph_eager_cells_over_1e-5": [c for _, c in ge],
        "eager_eager_mu_rel": [mu_diff(a, b) for a, b in
                               itertools.combinations(eager, 2)],
        "graph_eager_mu_rel": [mu_diff(g, e) for g in graph for e in eager],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    qcuda.build(qcuda.sources())
    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
    from qed_splatter_tpu_torch.engine.trainer import Trainer

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "room"
        chip_smoke.write_room(root)
        cfg = chip_smoke.bilateral_config(str(root), str(Path(tmp) / "run"),
                                          args.seed, True)
        t = Trainer(cfg, datamanager=FullImageDatamanager(cfg.data,
                                                          seed=args.seed))
        # the frames of the run's first chunk, put back for the run
        first = t._next_perm(chip_smoke.BILATERAL_CHUNK)
        t._queue = first + t._queue
        lines.append({"state": "zero moments",
                      **spread(t, first, args.runs)})
        print(json.dumps(lines[-1]), flush=True)
        t.train(finalize=False)
        lines.append({"state": f"after {int(t.state.step)} steps",
                      **spread(t, t._next_perm(chip_smoke.BILATERAL_CHUNK),
                               args.runs)})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
