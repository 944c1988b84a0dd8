"""Run one cell of the benchmark of ``qed_splatter_tpu_torch`` once.

    python3 -m splatbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a profiler over part of the window).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit.
The same numbers are the last lines of standard error. Without a usable
card, with fewer cards than the cell asks for, or when the process holds
a module of JAX or of the JAX package once the window has closed, it
prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "qed_splatter_tpu"}


def _environment() -> None:
    """Every build and kernel cache at a fixed directory in the checkout,
    and no library loading JAX behind the program's back."""
    cache = ROOT / ".splatbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Modules in this process whose top-level name is JAX's, Flax's or
    the JAX package's (compared whole)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _card(chips: int):
    import torch

    if not torch.cuda.is_available():
        return None, "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return None, (f"the cell asks for {chips} cards, "
                      f"torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0), None


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(cell, out: dict, trace: bool, kind: str, count: int) -> dict:
    from splatbench import spec, yardstick

    run = out["run"]
    entries = cell.per_layer if trace else cell.end_to_end
    res = {"correct": bool(out["checks"]["correct"]),
           "attempted": int(out["attempted"]),
           "failed": int(out["failed"]),
           "metrics": spec.read_metrics(entries, run),
           "device": {"platform": "gpu", "kind": kind, "count": count,
                      "memory_peak_bytes": int(run.peak_bytes)}}
    if trace and run.trace is not None:
        res["device"]["busy_s"] = run.trace["busy_s"]
        res["device"]["window_s"] = run.trace["window_s"]
        res["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
        if run.trace["stages"] and run.trace["busy_s"] > 0:
            cover = sum(run.trace["stages"].values()) / run.trace["busy_s"]
            print(f"the program's stages cover {100 * cover:.2f}% of the "
                  "traced busy time", file=sys.stderr)
        by_time = sorted(run.trace["kernels"].items(), key=lambda x: -x[1])
        matched = [(yardstick.kernel_entry(n), n, s) for n, s in by_time]
        print("kernels with a roofline (s in the trace): "
              + "; ".join(f"{e}: {n[:60]} {s:.6f}" for e, n, s in matched
                          if e is not None), file=sys.stderr)
        other = [f"{n[:90]} {s:.6f}" for e, n, s in matched if e is None]
        print("kernels that count toward no roofline (s in the trace): "
              + "; ".join(other[:12]), file=sys.stderr)
    res["checks"] = out["checks"]["checks"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from splatbench import spec

    cell = spec.load_cell(args.workload)
    kind, why = _card(cell.chips)
    if kind is None:
        print(f"splatbench: no result: {why}", file=sys.stderr)
        return 2
    from splatbench import harness

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace))
    try:
        bad = forbidden_modules()
        if bad:
            print("splatbench: no result: the process holds "
                  + ", ".join(bad), file=sys.stderr)
            return 3
        res = result_line(cell, out, bool(args.trace), kind, cell.chips)
    finally:
        shutil.rmtree(out["work"], ignore_errors=True)
    parts = ", ".join(f"{n} {v:.3f} s" for n, v in out["setup_parts"].items())
    tables = ", ".join(f"{k}/{t}" for k, t in out["tables"])
    print(f"setup {out['run'].setup_s:.3f} s: {parts}; K/pair budget in "
          f"the window {tables}; card {_power_limit()}")
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
