"""Metrics writer: JSONL, console, and optional TensorBoard, wandb and comet
backends (port of ``engine/writer.py``).

Every row goes to ``<run_dir>/metrics.jsonl`` as ``{"step", "split",
...metrics, "iters_per_s"}``; a console line every ``console_every`` steps
or when forced. The trainer's ``vis`` picks one more backend: TensorBoard
event files under ``<run_dir>/tb`` (``torch.utils.tensorboard``), a wandb
run or a comet experiment. Each is imported when asked for; nothing is
installed, and a backend that cannot be imported or started is reported on
the console and left out, so the JSONL rows are written all the same.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsWriter:
    def __init__(self, output_dir, console_every: int = 100,
                 use_tensorboard: bool = False, use_wandb: bool = False,
                 use_comet: bool = False,
                 project: str = "qed-splatter-tpu"):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self.console_every = console_every
        self._t_last = time.perf_counter()
        self._step_last = 0
        self._tb = self._wandb = self._comet = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.dir / "tb"))
            except Exception as e:  # an optional backend: JSONL goes on
                print(f"tensorboard unavailable ({e}); writing JSONL only")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, dir=str(self.dir),
                                         resume="allow")
            except Exception as e:
                print(f"wandb unavailable ({e}); writing JSONL only")
        if use_comet:
            try:
                import comet_ml

                self._comet = comet_ml.Experiment(project_name=project)
            except Exception as e:
                print(f"comet unavailable ({e}); writing JSONL only")

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
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
        named = {f"{prefix}/{k}": v for k, v in clean.items()}
        if self._wandb is not None:
            self._wandb.log(named, step=step)
        if self._comet is not None:
            self._comet.log_metrics(named, step=step)
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
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._comet is not None:
            self._comet.end()
