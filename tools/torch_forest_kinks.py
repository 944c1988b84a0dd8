#!/usr/bin/env python3
"""How many pixels of the forest's final gradient check lie on another
branch of the loss's clamp, over several trainings of the forest.

    python3 tools/torch_forest_kinks.py [--seed 0] [--runs 3]

``chip_smoke.py``'s forest phase trains BASELINE config #4 through ``cli
train --supervise`` and then holds one step's gradients on the final
state against the plain path, masking the pixels where the two paths take
another branch of a kink of the loss and bounding their count by kind
(``hold_grads``). The clamp of rgb to [0, 1] is one such kink. This script
runs the phase ``--runs`` times and reports, for each run, the clamp kinks
as the smoke counts them (the branch the clamp's gradient takes,
``loss_branch_kinds``), bounded (``clamp``) and within rounding of the
edge on an opaque pixel (``clamp_opaque``), and as a plain comparison of
the clamped values with the edges would count them, and for each clamp
kink of either kind the two paths' rgb and alpha there and the ground
truth. A run whose counts pass a bound of the phase is reported, not
stopped.

One JSON line at the end. Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    from qed_splatter_tpu_torch import cuda as qcuda

    qcuda.build(qcuda.sources())
    kinds_of = chip_smoke.loss_branch_kinds
    readings = []

    def recording(a, b, batch):
        kinds = kinds_of(a, b, batch)
        if any(r["frame"] is a for r in readings):
            return kinds
        clamped = kinds["clamp"] | kinds["clamp_opaque"]
        by_value = torch.zeros_like(clamped)
        for edge in (0.0, 1.0):
            by_value |= ((a.rgb == edge) != (b.rgb == edge)).any(-1)
        pixels = [{
            "yx": [y, x],
            "rgb": [a.rgb[y, x].tolist(), b.rgb[y, x].tolist()],
            "alpha": [float(a.accumulation[y, x]),
                      float(b.accumulation[y, x])],
            "gt": batch["rgb"][y, x].tolist()}
            for y, x in clamped.nonzero().tolist()]
        readings.append({"frame": a, "clamp": int(kinds["clamp"].sum()),
                         "clamp_opaque": int(kinds["clamp_opaque"].sum()),
                         "clamp_by_value": int(by_value.sum()),
                         "pixels": pixels})
        return kinds

    chip_smoke.loss_branch_kinds = recording
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            failed = None
            readings.clear()
            try:
                chip_smoke.phase_forest(args.seed, Path(tmp) / f"run{i}")
            except chip_smoke.SmokeFailure as e:
                failed = str(e)
            # the check's own frames come first (the masked re-check after)
            r = {k: v for k, v in readings[0].items() if k != "frame"}
            readings.clear()
            torch.cuda.empty_cache()
            r["failed"] = failed
            print(f"run {i}: clamp kinks {r['clamp']}, clamp_opaque "
                  f"{r['clamp_opaque']} (by the clamped values "
                  f"{r['clamp_by_value']}); "
                  f"{'failed: ' + failed if failed else 'the phase held'}",
                  flush=True)
            for p in r["pixels"]:
                print(f"  {p}")
            runs.append(r)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
