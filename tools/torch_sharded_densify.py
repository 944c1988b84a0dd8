#!/usr/bin/env python3
"""What moves the view-parallel run's eval PSNR: camera opt or the
densification threshold (H100).

    python3 tools/torch_sharded_densify.py [--seed 0]

Trains the room of ``chip_smoke.py``'s sharded phase (its config: 200 steps
at half resolution, the pair budget held) single-device and at 2x1 (two
cameras a step, two gloo ranks sharing cuda:0 through ``cli train``), each
with the default config, with camera opt off, and the 2x1 run also at a
half and a quarter of ``densify_grad_thresh``: the view-parallel step (the
JAX package's semantics) feeds refine the norm of the camera-summed absgrad
of loss / B against a visibility count of B. Prints, for every run, its
eval PSNR at 200, the gaussians after each refine and the last loss, and
ONE JSON dict of the same.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qed_splatter_tpu_torch import cli
    from qed_splatter_tpu_torch import cuda as qcuda
    from qed_splatter_tpu_torch.engine.trainer import Trainer

    qcuda.build(qcuda.sources())
    off = ["--model.camera-opt-mode", "off"]
    thresh = cli.build_trainer_config(
        ["--data", "x"])[0].model.densify_grad_thresh
    runs = [("single", 1, []), ("single_cam_off", 1, off),
            ("d2", 2, []), ("d2_cam_off", 2, off),
            ("d2_half", 2, ["--model.densify-grad-thresh", str(thresh / 2)]),
            ("d2_quarter", 2,
             ["--model.densify-grad-thresh", str(thresh / 4)])]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, work = Path(tmp) / "room", Path(tmp) / "runs"
        cs.write_room(root)
        base = ["--data", str(root), "--output-dir", str(work), "--seed",
                str(args.seed), *cs.SHARDED_FLAGS]
        for name, shards, extra in runs:
            argv_run = [*base, "--experiment-name", name, *extra]
            if shards == 1:
                cfg, device = cli.build_trainer_config(argv_run)
                Trainer(cfg, device=device).train()
                torch.cuda.empty_cache()
            else:
                res = subprocess.run(
                    [sys.executable, "-m", "qed_splatter_tpu_torch.cli",
                     "train", *argv_run, "--num-data-shards", str(shards)],
                    capture_output=True, text=True, timeout=900, cwd=ROOT)
                if res.returncode:
                    print(res.stdout[-3000:] + res.stderr[-3000:])
                    return res.returncode
            run = work / name
            out[name] = {
                "psnr": cs.metrics_rows(run, "eval_all")[-1]["rgb_psnr"],
                "refines": [(r["step"], r["n_alive"]) for r in
                            cs.metrics_rows(run, "refine")],
                "last_loss": cs.metrics_rows(run, "train")[-1]["loss"]}
            print(f"{name}: {out[name]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
