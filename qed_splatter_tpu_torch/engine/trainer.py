"""The trainer: setup, the per-step loop, cadences, growth, checkpoints
(port of ``engine/trainer.py``).

One call of :meth:`Trainer.train` runs the per-step loop to the budget:

- the coarse-to-fine resolution schedule (``2^max(num_downscales - step //
  resolution_schedule, 0)``), with a step per (width, height, depth, mask,
  capacity, absgrad, K, pair budget) bucket;
- per resolution bucket, an adaptive per-tile K (``_maybe_adapt_k``) and an
  adaptive pair-expansion budget (``_maybe_adapt_tpg``), both carried into
  the step (the JAX package's step cache misses the budget; this one keys
  on it);
- refine and the opacity reset every ``refine_every`` steps after the
  warm-up, frozen after a rollback;
- host-side capacity growth (x2 up to ``max_capacity``) when more than 85%
  of the slots are alive. On CUDA an out-of-memory error is an exception,
  so the growth needs no compile probe: a copy of the state before the
  growth is kept on the CPU until the refine and the first step at the new
  capacity have run, and an ``OutOfMemoryError`` in either restores it and
  refuses that capacity;
- a lagged divergence watch (the loss of step N is read after step N + 1
  ran) with the params canary, and halt, rollback to the last finite
  checkpoint, or ignore;
- eval renders that re-render once at a doubled K when they truncated;
- checkpoints, and ``finalize``: a checkpoint (with the pair-budget table,
  which the JAX package's ``finalize`` drops) and ``splat.ply``;
- with ``profile_dir``, a ``torch.profiler`` trace (CPU and, on CUDA, the
  device) of steps start + 10 to start + 14 of each :meth:`Trainer.train`
  call, the JAX trainer's window, written as a Chrome trace beside a
  ``key_averages`` table.

The step updates parameters and moments in place, so every checkpoint,
pre-growth state and rollback target is a copy. Random draws come from
``torch.Generator``\\ s seeded from (seed, step); the camera order is the
datamanager's.

Not ported, each refused with :class:`NotImplementedError` naming its
ROADMAP item: multi-step dispatch (``steps_per_dispatch`` other than 0 or
1; 0 runs this loop), ``supervise`` and the attempt journal, more than one
data or model shard, the viewer, the TensorBoard / wandb / comet writers
and the bilateral grid. ``TrainerConfig.mixed_precision`` turns on the
model's (the bf16 operand compositing kernels), as in the JAX trainer.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from qed_splatter_tpu_torch import not_ported, resolve_device
from qed_splatter_tpu_torch.configs import TrainerConfig
from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine.densify import (
    DensifyStats,
    maybe_reset_opacities,
    refine,
)
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
    refuse_bilateral_grid,
)
from qed_splatter_tpu_torch.engine.writer import MetricsWriter
from qed_splatter_tpu_torch.metrics import (
    RGBMetrics,
    avg_min_scale,
    full_eval_metrics,
)
from qed_splatter_tpu_torch.models.gaussians import (
    grow_capacity,
    init_from_points,
    init_random,
    pad_rows,
)
from qed_splatter_tpu_torch.models.splatfacto import render, total_loss


def downscale_image(img: np.ndarray, d: int) -> np.ndarray:
    """Box-average downscale by an integer factor (float32 out)."""
    if d <= 1:
        return img
    h, w = img.shape[:2]
    hh, ww = h // d, w // d
    img = img[: hh * d, : ww * d]
    return img.reshape(hh, d, ww, d, -1).astype(np.float32).mean(axis=(1, 3))


def downscale_depth(depth: np.ndarray, d: int) -> np.ndarray:
    """Nearest-sample downscale: metric depth must not blend across
    edges."""
    if d <= 1:
        return depth
    return depth[d // 2:: d, d // 2:: d][
        : depth.shape[0] // d, : depth.shape[1] // d]


class TrainingDiverged(RuntimeError):
    """Training went non-finite and could not (or must not, per
    ``TrainerConfig.on_divergence``) be rolled back."""


def _refuse_unported(config: TrainerConfig) -> None:
    if config.steps_per_dispatch not in (0, 1):
        raise not_ported(
            f"steps_per_dispatch={config.steps_per_dispatch} (multi-step "
            f"dispatch)", 1, "multi-step dispatch as a CUDA graph of the "
            f"step")
    if config.supervise:
        raise not_ported("supervise=True (the crash supervisor and its "
                         "attempt journal)", 2,
                         "the attempt journal and supervise")
    if config.num_data_shards * config.num_model_shards > 1:
        raise not_ported("num_data_shards / num_model_shards > 1", 8,
                         "parallel/* and multi_scene")
    if config.vis == "viewer":
        raise not_ported("vis='viewer'", 10, "the viewer")
    if config.vis in ("tensorboard", "wandb", "comet"):
        raise not_ported(
            f"the {config.vis} metrics backend (of tensorboard, wandb and "
            f"comet; the port writes JSONL and the console)", 9,
            "the remaining CLI subcommands and writer backends")
    if config.model.use_bilateral_grid:
        raise refuse_bilateral_grid()


class Trainer:
    def __init__(self, config: TrainerConfig,
                 datamanager: Optional[FullImageDatamanager] = None,
                 optims: Optional[GroupOptimizers] = None,
                 device="cuda"):
        _refuse_unported(config)
        if config.steps_per_dispatch == 0:
            print("steps_per_dispatch=0 (auto) runs the per-step loop: "
                  "multi-step dispatch waits for ROADMAP.md 'Next, in "
                  "order' item 1 (a CUDA graph of the step)")
        if not config.data.data and datamanager is None:
            raise ValueError("TrainerConfig.data.data is required")
        self.config = config
        self.cfg = self._model_config(config)
        self.device = resolve_device(device)
        self.dm = datamanager or FullImageDatamanager(config.data,
                                                      seed=config.seed)
        self.optims = optims or GroupOptimizers(config.optimizers)
        self.run_dir = (Path(config.output_dir)
                        / (config.experiment_name or "qed-splatter"))
        self.writer = MetricsWriter(self.run_dir,
                                    console_every=config.log_every)
        self.rgb_metrics = RGBMetrics()
        self._step_fns: Dict[Tuple, object] = {}
        # device batches by (camera, downscale), while they fit the budget
        self._batches: Dict[Tuple[int, int], Tuple] = {}
        self._batch_bytes = 0
        self._grow_refused: set = set()
        # (pre-growth capacity, new capacity, pre-growth copy on the CPU)
        # until the refine and the first step at the new capacity ran
        self._canary: Optional[Tuple[int, int, TrainState]] = None
        self._rollbacks = 0
        self._densify_frozen_until = 0
        self._good_ckpt: Optional[int] = None   # step of a finite ckpt
        # adaptive per-tile K and pair budget, per resolution bucket
        self._k_by_d: Dict[int, int] = {}
        self._tpg_by_d: Dict[int, int] = {}
        self.state = self._setup_state()

    # ------------------------------------------------------------ setup

    @staticmethod
    def _model_config(config: TrainerConfig):
        """The model config the steps read: ``TrainerConfig.mixed_precision``
        (the user-facing flag) turns on the model's."""
        if config.mixed_precision and not config.model.mixed_precision:
            return dataclasses.replace(config.model, mixed_precision=True)
        return config.model

    def _setup_state(self) -> TrainState:
        """The state restored from ``load_dir`` (with its adaptive tables),
        else a fresh one from the scene's seed points (or a random cube)."""
        if self.config.load_dir:
            latest = ckpt.latest_checkpoint(self.config.load_dir)
            if latest is None:
                raise FileNotFoundError(
                    f"--load-dir {self.config.load_dir!r} contains no "
                    "checkpoint (expected step-XXXXXXXXX dirs under "
                    "<output-dir>/<experiment-name>/ckpts)")
            meta = ckpt.checkpoint_meta(latest) or {}
            for dd, kk in (meta.get("k_by_d") or {}).items():
                self._k_by_d[int(dd)] = int(kk)
            for dd, kk in (meta.get("tpg_by_d") or {}).items():
                self._tpg_by_d[int(dd)] = int(kk)
            state = ckpt.restore_checkpoint(latest, self.device)
            print(f"Resumed from {latest} at step {state.step}")
            return state
        scene = self.dm.scene
        common = dict(sh_degree=self.cfg.sh_degree,
                      capacity_headroom=self.cfg.init_capacity_headroom,
                      seed=self.config.seed, device=self.device)
        if scene.points is not None and not self.cfg.random_init:
            params = init_from_points(scene.points, scene.points_rgb,
                                      **common)
        else:
            params = init_random(num_points=self.cfg.num_random,
                                 random_scale=self.cfg.random_scale, **common)
        return init_train_state(params, self.optims,
                                num_cameras=len(scene.frames))

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """A generator for one draw of one step: the random background
        (stream 0) or refine's split offsets (stream 1)."""
        seed = (self.config.seed * 1_000_003 + step) * 2 + stream
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------- step plumbing

    def _downscale_factor(self, step: int) -> int:
        """2^max(num_downscales - step // schedule, 0) (splatfacto)."""
        return 2 ** max(
            self.cfg.num_downscales - step // self.cfg.resolution_schedule,
            0)

    def _get_step_fn(self, width, height, has_depth, has_mask, capacity,
                     need_absgrad=True):
        key = (width, height, has_depth, has_mask, capacity, need_absgrad,
               self.cfg.max_per_tile, self.cfg.small_tiles_per_gaussian)
        if key not in self._step_fns:
            self._step_fns[key] = make_train_step(
                self.cfg, self.optims, width, height, has_depth=has_depth,
                has_mask=has_mask, need_absgrad=need_absgrad,
                device=self.device)
        return self._step_fns[key]

    def _prepare_batch(self, item: Dict, d: int):
        """(batch on the device, camera, has_depth, has_mask) of one item at
        downscale ``d``; kept on the device while the batches of all
        cameras fit ``max_device_cache_bytes``."""
        key = (int(item["cam_idx"]), d)
        if key in self._batches:
            return self._batches[key]
        cam = item["camera"].rescaled(1.0 / d) if d > 1 else item["camera"]
        dev = self.device
        rgb = np.asarray(downscale_image(item["image"], d), np.float32) / 255.0
        batch = dict(
            c2w=torch.as_tensor(cam.c2w, dtype=torch.float32, device=dev),
            K=torch.as_tensor(cam.intrinsics_matrix(), device=dev),
            cam_idx=int(item["cam_idx"]),
            rgb=torch.as_tensor(rgb, device=dev),
        )
        has_depth = "depth_image" in item
        if has_depth:
            batch["depth"] = torch.as_tensor(
                np.ascontiguousarray(downscale_depth(item["depth_image"], d)),
                device=dev)
        has_mask = "mask" in item
        if has_mask:
            m = downscale_image(item["mask"] * 255.0, d) / 255.0
            batch["mask"] = torch.as_tensor(
                (m > 0.5).astype(np.float32), device=dev)
        out = (batch, cam, has_depth, has_mask)
        size = sum(v.numel() * v.element_size() for v in batch.values()
                   if isinstance(v, torch.Tensor))
        if self._batch_bytes + size <= self.config.max_device_cache_bytes:
            self._batches[key] = out
            self._batch_bytes += size
        return out

    @staticmethod
    def _grown_state(state: TrainState, new_cap: int) -> TrainState:
        """``state`` at capacity ``new_cap``: dead slots with unit
        quaternions, zero moments and zero stats (new tensors)."""
        return dataclasses.replace(
            state,
            params=grow_capacity(state.params, new_cap),
            opt_state={g: dict(s, mu=pad_rows(s["mu"], new_cap),
                               nu=pad_rows(s["nu"], new_cap))
                       for g, s in state.opt_state.items()},
            stats=DensifyStats(*(
                pad_rows(getattr(state.stats, f.name), new_cap)
                for f in dataclasses.fields(DensifyStats))),
        )

    def _maybe_grow(self, cur: int, max_hw: int) -> bool:
        """Double the capacity (up to ``max_capacity``) when more than 85%
        of the slots are alive and that capacity was not refused, ahead of
        the refine at step ``cur``; keeps the pre-growth state on the CPU as
        the canary's way back, and what that refine needs to run again."""
        cap = self.state.params.capacity
        if not (int(self.state.params.num_alive()) > 0.85 * cap
                and cap < self.cfg.max_capacity):
            return False
        new_cap = min(cap * 2, self.cfg.max_capacity)
        if new_cap in self._grow_refused:
            return False
        pre = ckpt.copy_state(self.state, "cpu")
        print(f"Growing gaussian capacity {cap} -> {new_cap}")
        self.state = self._grown_state(self.state, new_cap)
        self._canary = (cap, new_cap, pre, cur, max_hw)
        self.writer.write(self.state.step, {"capacity_before": cap,
                                            "capacity_after": new_cap},
                          prefix="grow")
        return True

    def _revert_growth(self, cur: int, err: Exception) -> None:
        """The refine or step after a growth ran out of memory: restore the
        pre-growth state and refuse that capacity."""
        pre_cap, new_cap, pre = self._canary[:3]
        print(f"GROWTH CANARY FAILED at step {cur} (capacity {pre_cap} -> "
              f"{new_cap}): {type(err).__name__}: {str(err)[:300]}. "
              f"Restoring the pre-growth state and refusing capacity "
              f"{new_cap}.")
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.state = ckpt.copy_state(pre, self.device)
        self._grow_refused.add(new_cap)
        self._canary = None

    # ------------------------------------------------------------- train

    def _refine(self, cur: int, max_hw: int):
        s = self.state
        params, opt_state, stats, info = refine(
            s.params, s.opt_state, s.stats, s.step, self.cfg,
            num_train_data=self.dm.num_train, max_hw=max_hw,
            generator=self._generator(cur, 1))
        params, opt_state = maybe_reset_opacities(params, opt_state, s.step,
                                                  self.cfg)
        self.state = dataclasses.replace(s, params=params,
                                         opt_state=opt_state, stats=stats)
        return info

    def _callbacks(self, cur: int, max_hw: int) -> None:
        """Refine / eval / checkpoint cadences after step ``cur``."""
        cfgt = self.config
        if (cur > self.cfg.warmup_length and cur % self.cfg.refine_every == 0
                and cur >= self._densify_frozen_until):
            grown = self._maybe_grow(cur, max_hw)
            try:
                info = self._refine(cur, max_hw)
            except torch.cuda.OutOfMemoryError as e:
                if not grown:
                    raise
                self._revert_growth(cur, e)
                info = self._refine(cur, max_hw)
            self.writer.write(cur, info._asdict(), prefix="refine")
        if cfgt.steps_per_eval_image and cur % cfgt.steps_per_eval_image == 0:
            self.eval_image(cur)
        if cfgt.steps_per_eval_batch and cur % cfgt.steps_per_eval_batch == 0:
            self.eval_batch(cur)
        if (cfgt.steps_per_eval_all_images
                and cur % cfgt.steps_per_eval_all_images == 0):
            self.eval_all(cur)
        if cfgt.steps_per_save and cur % cfgt.steps_per_save == 0:
            self._save(self.run_dir / "ckpts", cur)
            # a rollback target only if the params are finite
            if self._state_finite():
                self._good_ckpt = cur

    def _save(self, ckpt_dir: Path, step: int) -> Path:
        return ckpt.save_checkpoint(
            ckpt_dir, self.state, step,
            dataparser_transform=self.dm.scene.transform_matrix,
            dataparser_scale=self.dm.scene.scale_factor,
            model_config=self.cfg, k_by_d=self._k_by_d,
            tpg_by_d=self._tpg_by_d)

    # ------------------------------------------------- divergence handling

    def _state_finite(self) -> bool:
        """The params canary: a fully poisoned model renders pure
        background with a finite loss, so the loss alone is not enough."""
        p = self.state.params
        s = (p.means.sum() + p.scales.sum() + p.quats.sum()
             + p.opacities.sum() + self.state.camera_opt.sum())
        return bool(torch.isfinite(s))

    def _handle_divergence(self, step: int) -> int:
        """Non-finite loss or params after ``step``: a post-mortem
        checkpoint, then rollback or halt per ``on_divergence``. Returns
        the step to continue from."""
        mode = self.config.on_divergence
        print(f"DIVERGENCE at step {step}: non-finite loss or params "
              f"(policy={mode}, rollbacks so far={self._rollbacks})")
        self._save(self.run_dir / "postmortem", step)
        if mode == "ignore":
            return step
        if (mode == "rollback" and self._good_ckpt is not None
                and self._rollbacks < self.config.max_rollbacks):
            good = self._good_ckpt
            path = self.run_dir / "ckpts" / f"step-{good:09d}"
            self.state = None
            self.state = ckpt.restore_checkpoint(path, self.device)
            self._rollbacks += 1
            self._densify_frozen_until = (
                good + self.config.divergence_freeze_steps)
            print(f"Rolled back to finite checkpoint step {good} (capacity "
                  f"{self.state.params.capacity}); densification frozen "
                  f"until step {self._densify_frozen_until}")
            return good
        raise TrainingDiverged(
            f"training diverged at step {step} and could not roll back "
            f"(mode={mode}, good_ckpt={self._good_ckpt}, rollbacks="
            f"{self._rollbacks}/{self.config.max_rollbacks}); post-mortem "
            f"under {self.run_dir / 'postmortem'}")

    # ------------------------------------------- adaptive K / pair budget

    def _k_for(self, d: int) -> int:
        """Per-resolution-bucket K; a bucket seen for the first time starts
        at the max of the coarser buckets visited (or the config)."""
        if d not in self._k_by_d:
            coarser = [k for dd, k in self._k_by_d.items() if dd > d]
            self._k_by_d[d] = max([self.config.model.max_per_tile, *coarser])
        return self._k_by_d[d]

    def _maybe_adapt_k(self, overflow, max_count, width: int, height: int,
                       d: int) -> None:
        """Grow K (x2, to the limit) when the cap truncates more than 10% of
        per-tile intersections; shrink it to the next power of two covering
        1.25x the max per-tile count when it is 2.5x oversized."""
        cfg = self.cfg
        if not cfg.adaptive_max_per_tile or overflow is None:
            return
        k_now = self._k_for(d)
        ts = cfg.tile_size
        t = (-(-width // ts)) * (-(-height // ts))
        k_limit = cfg.max_per_tile_limit
        if overflow > 0.10 * t * k_now and k_now < k_limit:
            new_k = min(k_now * 2, k_limit)
            print(f"Growing max_per_tile {k_now} -> {new_k} at 1/{d} res "
                  f"(tile_overflow {overflow:.0f})")
            self._k_by_d[d] = new_k
        elif (max_count is not None and max_count * 2.5 < k_now
              and k_now > min(512, cfg.max_per_tile)):
            fit = 2 ** math.ceil(math.log2(max(max_count * 1.25, 1.0)))
            new_k = max(int(fit), min(512, cfg.max_per_tile))
            if new_k < k_now:
                print(f"Shrinking max_per_tile {k_now} -> {new_k} at 1/{d} "
                      f"res (max per-tile count {max_count:.0f})")
                self._k_by_d[d] = new_k

    def _tpg_for(self, d: int) -> int:
        """Pair-expansion budget of bucket 1/d, seeded as :meth:`_k_for`."""
        if d not in self._tpg_by_d:
            coarser = [k for dd, k in self._tpg_by_d.items() if dd > d]
            self._tpg_by_d[d] = max(
                [self.config.model.small_tiles_per_gaussian, *coarser])
        return self._tpg_by_d[d]

    def _maybe_adapt_tpg(self, bbox_truncated, d: int) -> None:
        """Grow the pair budget (x2, to ``max_tiles_per_gaussian``) when
        more than 0.5% of the alive splats lose bbox cells."""
        cfg = self.cfg
        if not cfg.adaptive_pair_budget or bbox_truncated is None:
            return
        tpg_now = self._tpg_for(d)
        alive = max(int(self.state.params.num_alive()), 1)
        if (bbox_truncated > 0.005 * alive
                and tpg_now < cfg.max_tiles_per_gaussian):
            new_tpg = min(tpg_now * 2, cfg.max_tiles_per_gaussian)
            print(f"Growing pair budget {tpg_now} -> {new_tpg} at 1/{d} "
                  f"res (bbox_truncated {bbox_truncated:.0f} of {alive})")
            self._tpg_by_d[d] = new_tpg

    def _sync_bucket_cfg(self, d: int) -> None:
        k, tpg = self._k_for(d), self._tpg_for(d)
        if (self.cfg.max_per_tile, self.cfg.small_tiles_per_gaussian) != (
                k, tpg):
            self.cfg = dataclasses.replace(self.cfg, max_per_tile=k,
                                           small_tiles_per_gaussian=tpg)

    # ------------------------------------------------------------- loop

    def train(self, max_steps: Optional[int] = None,
              finalize: bool = True) -> TrainState:
        """Train to ``max_steps`` (default: the configured budget), then
        ``finalize`` unless told not to."""
        cfgt = self.config
        total = max_steps or cfgt.max_num_iterations
        start_step = self.state.step
        t0 = time.perf_counter()
        step = start_step
        # the loss of step N is read after step N + 1 ran
        prev_loss = None
        # the profiler's window, the JAX trainer's: steps start + 10 to
        # start + 14 (once, whatever a rollback does to the step)
        prof, traced = None, not cfgt.profile_dir
        while step < total:
            if not traced and step == start_step + 10:
                prof, traced = self._start_profile(), True
            d = self._downscale_factor(step)
            self._sync_bucket_cfg(d)
            item = self.dm.next_train(step)
            batch, cam, has_depth, has_mask = self._prepare_batch(item, d)
            step_fn = self._get_step_fn(
                cam.width, cam.height, has_depth, has_mask,
                self.state.params.capacity,
                # absgrad stats matter only while densification can run
                need_absgrad=step < self.cfg.stop_split_at)
            try:
                self.state, metrics = step_fn(self.state, batch,
                                              self._generator(step, 0))
            except torch.cuda.OutOfMemoryError as e:
                if self._canary is None:
                    raise
                refine_at = self._canary[3:]
                self._revert_growth(step, e)
                # the pre-growth state is from before that cadence's refine:
                # run it again (with its reset and stats reset) at the old
                # capacity, as a failed refine is run again
                info = self._refine(*refine_at)
                self.writer.write(refine_at[0], info._asdict(),
                                  prefix="refine")
                continue
            self._canary = None
            cur = step = step + 1
            if prof is not None and cur == start_step + 15:
                self._stop_profile(prof, start_step + 10, cur)
                prof = None

            if prev_loss is not None and not math.isfinite(float(prev_loss)):
                step = self._handle_divergence(cur - 1)
                prev_loss = None
                continue
            prev_loss = metrics["loss"]

            if cur % cfgt.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                self.writer.write(cur, host, prefix="train")
                self._maybe_adapt_k(host.get("tile_overflow"),
                                    host.get("tile_max_count"),
                                    cam.width, cam.height, d)
                self._maybe_adapt_tpg(host.get("bbox_truncated"), d)
                if not math.isfinite(host["loss"]) or not self._state_finite():
                    step = self._handle_divergence(cur)
                    prev_loss = None
                    continue
            self._callbacks(cur, max(cam.width, cam.height))

        if prof is not None:
            self._stop_profile(prof, start_step + 10, step)
        done = total - start_step
        if done > 0:
            wall = time.perf_counter() - t0
            print(f"Trained {done} steps in {wall:.1f}s "
                  f"({done / max(wall, 1e-9):.2f} iters/s)")
        if finalize:
            self.finalize(total)
        return self.state

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, first: int, end: int) -> Path:
        """Stop the trace of steps [first, end) and write it into
        ``profile_dir``: ``trace_steps_<first>-<end - 1>.json`` (Chrome
        trace) and ``key_averages_steps_<first>-<end - 1>.txt``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.config.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        name = f"steps_{first}-{end - 1}"
        path = out / f"trace_{name}.json"
        prof.export_chrome_trace(str(path))
        sort = ("cuda_time_total" if self.device.type == "cuda"
                else "cpu_time_total")
        (out / f"key_averages_{name}.txt").write_text(
            prof.key_averages().table(sort_by=sort, row_limit=60))
        print(f"Profile of steps {first}-{end - 1} written to {path}")
        return path

    def finalize(self, total: Optional[int] = None) -> None:
        """End-of-training checkpoint (with both adaptive tables) and
        ``splat.ply``."""
        self._save(self.run_dir / "ckpts",
                   total if total is not None else self.state.step)
        meta = ckpt.checkpoint_meta(self.run_dir / "ckpts")
        ckpt.export_ply(self.run_dir / "splat.ply", self.state.params, meta)

    # -------------------------------------------------------------- eval

    def _k_eval(self, d: int) -> int:
        """K for eval renders: the max adaptive K over all buckets (eval
        views get no overflow feedback and a shrunk K could truncate)."""
        return max([self._k_for(d), *self._k_by_d.values()])

    def _render_eval(self, item: Dict, d: int = 1):
        cam = item["camera"].rescaled(1.0 / d) if d > 1 else item["camera"]
        k = self._k_eval(d)
        # the largest escalated pair budget: eval never bbox-truncates more
        # than training
        tpg = max([self.config.model.small_tiles_per_gaussian,
                   *self._tpg_by_d.values()])
        while True:
            eval_cfg = dataclasses.replace(self.cfg, max_per_tile=k,
                                           small_tiles_per_gaussian=tpg)
            out = render(self.state.params, cam.c2w, cam.intrinsics_matrix(),
                         cam.width, cam.height, eval_cfg,
                         step=self.state.step, train=False,
                         device=self.device)
            # re-render once at a doubled K (to the limit) when the
            # per-tile lists truncated, for an unbiased metric
            if (int(out.tile_overflow) > 0
                    and k < self.cfg.max_per_tile_limit):
                k = min(k * 2, self.cfg.max_per_tile_limit)
                continue
            return out, cam

    def _gt(self, item: Dict, d: int):
        gt = torch.as_tensor(np.asarray(downscale_image(item["image"], d),
                                        np.float32) / 255.0,
                             device=self.device)
        gt_depth = (torch.as_tensor(np.ascontiguousarray(downscale_depth(
            item["depth_image"], d)), device=self.device)
            if "depth_image" in item else None)
        return gt, gt_depth

    def _eval_item(self, step: int, every: int) -> Dict:
        idx = self.dm.scene.eval_indices[
            step // max(every, 1) % max(self.dm.num_eval, 1)]
        return self.dm.get_item(int(idx))

    def eval_image(self, step: int) -> Dict:
        """Eval metrics of one held-out image at the current resolution."""
        item = self._eval_item(step, self.config.steps_per_eval_image)
        d = self._downscale_factor(step)
        out, _ = self._render_eval(item, d)
        gt, gt_depth = self._gt(item, d)
        p = self.state.params
        metrics = full_eval_metrics(
            out.rgb, gt, out.depth, gt_depth, rgb_metrics=self.rgb_metrics,
            gaussian_count=int(p.num_alive()),
            avg_min_scale=float(avg_min_scale(p.scales, p.alive)))
        self.writer.write(step, metrics, prefix="eval", force_console=True)
        return metrics

    def eval_batch(self, step: int) -> Dict:
        """The loss terms on one held-out image, no optimizer step."""
        item = self._eval_item(step, self.config.steps_per_eval_batch)
        d = self._downscale_factor(step)
        out, _ = self._render_eval(item, d)
        gt, gt_depth = self._gt(item, d)
        _, losses = total_loss(out, gt, gt_depth, self.state.params,
                               self.cfg, self.state.step)
        losses = {k: float(v) for k, v in losses.items()}
        self.writer.write(step, losses, prefix="eval_loss")
        return losses

    def eval_all(self, step: int) -> Dict:
        """Eval metrics averaged over every held-out image at full
        resolution (NaN entries, e.g. LPIPS, left out of the mean)."""
        rows = []
        for item in self.dm.eval_items():
            out, _ = self._render_eval(item)
            gt, gt_depth = self._gt(item, 1)
            rows.append(full_eval_metrics(out.rgb, gt, out.depth, gt_depth,
                                          rgb_metrics=self.rgb_metrics))
        agg = {}
        for k in rows[0]:
            vals = np.asarray([m[k] for m in rows], np.float64)
            finite = vals[np.isfinite(vals)]
            agg[k] = float(finite.mean()) if finite.size else float("nan")
        agg["gaussian_count"] = int(self.state.params.num_alive())
        self.writer.write(step, agg, prefix="eval_all", force_console=True)
        return agg
