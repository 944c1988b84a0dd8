"""Metrics writer: JSONL + console (port of ``engine/writer.py``).

Every row goes to ``<run_dir>/metrics.jsonl`` as ``{"step", "split",
...metrics, "iters_per_s"}``; a console line every ``console_every`` steps
or when forced. The JAX package's optional TensorBoard, wandb and comet
backends are not ported: the trainer refuses ``vis`` set to one of them.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsWriter:
    def __init__(self, output_dir, console_every: int = 100):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self.console_every = console_every
        self._t_last = time.perf_counter()
        self._step_last = 0

    def write(self, step: int, metrics: Dict, prefix: str = "train",
              force_console: bool = False) -> None:
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        now = time.perf_counter()
        if step > self._step_last:
            clean["iters_per_s"] = (step - self._step_last) / max(
                now - self._t_last, 1e-9)
        self._t_last, self._step_last = now, step
        self._jsonl.write(json.dumps({"step": step, "split": prefix,
                                      **clean}) + "\n")
        if force_console or (
                self.console_every and step % self.console_every == 0):
            keys = [k for k in ("loss", "main_loss", "depth_loss", "psnr",
                                "rgb_psnr", "gaussian_count", "iters_per_s",
                                "n_alive", "n_culled", "n_split", "n_dup",
                                "depth_abs_rel", "depth_a1")
                    if k in clean]
            msg = " ".join(f"{k}={clean[k]:.4g}" for k in keys)
            print(f"[{prefix} {step}] {msg}", flush=True)

    def close(self) -> None:
        self._jsonl.close()
