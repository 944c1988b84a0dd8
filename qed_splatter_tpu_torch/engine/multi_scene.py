"""Multi-scene training: N scenes in one process (port of
``engine/multi_scene.py``).

- **Scenes by process**: process ``i`` of ``P`` owns scenes ``i::P``
  (whole scenes). The index and count come from ``torch.distributed`` when
  it is initialized, else 0 and 1.
- **Round robin**: each scene advances one refine interval (the dispatch
  chunk of the default cadences) per turn, so the scenes progress together.
- **One optimizer, one graph pool**: the trainers share one
  ``GroupOptimizers``. Each scene builds its own step and, on CUDA, its own
  graph (a graph is bound to its scene's state); kernel builds are cached
  per process, and every graph captures into one memory pool.

Checkpoints and metrics go under ``<output-dir>/<experiment>/<scene>/``;
``finalize`` runs once per scene at the end.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import torch

from qed_splatter_tpu_torch.configs import TrainerConfig
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.trainer import Trainer


def process_index_count() -> tuple:
    """(rank, world size) of ``torch.distributed``, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class MultiSceneTrainer:
    def __init__(self, config: TrainerConfig, scene_dirs: List[str],
                 device="cuda"):
        self.config = config
        pidx, pcnt = process_index_count()
        self.local_scenes = list(scene_dirs)[pidx::pcnt]
        if not self.local_scenes:
            raise ValueError(
                f"process {pidx}/{pcnt} was assigned no scenes "
                f"({len(scene_dirs)} scenes total); use at least one scene "
                "per process")
        names = [Path(s).name for s in self.local_scenes]
        if len(set(names)) != len(names):
            raise ValueError("scene directory names must be unique (they key "
                             f"the per-scene output dirs): {names}")
        exp = config.experiment_name or "qed-multi"
        self.optims = GroupOptimizers(config.optimizers)
        self.trainers: Dict[str, Trainer] = {}
        for scene in self.local_scenes:
            name = Path(scene).name
            scfg = dataclasses.replace(
                config, data=dataclasses.replace(config.data, data=scene),
                experiment_name=f"{exp}/{name}",
                # whole scenes per process: no view sharding inside one
                shard_views_by_process=False,
                # the live viewer binds a port; N scenes would collide
                vis="jsonl" if config.vis == "viewer" else config.vis)
            if scfg.load_dir:
                scfg = dataclasses.replace(
                    scfg, load_dir=str(Path(scfg.load_dir) / name / "ckpts"))
            self.trainers[name] = Trainer(scfg, optims=self.optims,
                                          device=device)

    def train(self, max_steps: Optional[int] = None) -> Dict[str, object]:
        """Round-robin every local scene to the budget, then finalize
        each."""
        total = max_steps or self.config.max_num_iterations
        chunk = max(1, min(self.config.model.refine_every, total))
        target = 0
        while target < total:
            target = min(target + chunk, total)
            for tr in self.trainers.values():
                if tr.state.step < target:
                    tr.train(max_steps=target, finalize=False)
        for tr in self.trainers.values():
            tr.finalize(total)
        return {name: tr.state for name, tr in self.trainers.items()}
