"""The trainer: setup, the dispatch loops, cadences, growth, checkpoints
and the crash journal (port of ``engine/trainer.py``).

One call of :meth:`Trainer.train` trains to the budget through one of two
loops, chosen as the JAX trainer chooses its scan:

- **multi-step dispatch** (``steps_per_dispatch`` > 1, or 0 when the
  chunk, the gcd of every cadence capped at 100, is above 1 and the image
  cache fits ``max_device_cache_bytes``): each chunk of steps runs through
  ``engine/scan_runner.py``, a CUDA graph of the step replayed once per
  step on CUDA (the same body eagerly on the CPU), on cameras from the
  epoch-permutation queue of ``_reseed_sampling`` and the bucket's frames
  on the device. Adaptive K and pair budget, the divergence check, refine,
  eval and save run between chunks, on one metrics row per chunk;
- **the per-step loop** (``steps_per_dispatch=1``, or 0 otherwise).

Both share:

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
  which the JAX package's ``finalize`` drops), ``splat.ply``, and
  ``kernel_launches.json``: this process's launches of each CUDA kernel and
  its variants (graph replays counted), the record of what the run ran
  when it ran in a child process (``--supervise``);
- the wall ms of each growth and each refine (with its opacity reset and
  growth check) in their metrics rows;
- with ``profile_dir``, tracing on (``tracing.py``: the step's stage marks,
  the host spans, the counters below) inside each :meth:`Trainer.train`
  call, as it was after, and a ``torch.profiler`` trace (CPU
  and, on CUDA, the device) of part of each :meth:`Trainer.train` call,
  written as a Chrome trace beside a ``key_averages`` table: on the
  per-step loop steps start + 10 to start + 14, the JAX trainer's window;
  on multi-step dispatch the first chunk that starts at or after start +
  10, with its callbacks;
- with tracing on, spans on the profiler's clock around each
  :meth:`Trainer.train` call (``qed.train``), each chunk (``qed.chunk``:
  ``qed.chunk.host`` before the dispatch and from the
  metrics read on, ``qed.chunk.bind``, ``qed.capture``,
  ``qed.chunk.replay``) and the host work between chunks (``qed.adapt``,
  ``qed.refine`` with ``.grow_check``, ``.densify`` and ``.reset``,
  ``qed.eval_image``, ``qed.state_finite``, ``qed.save``), and each
  chunk's counters (graph captures, device allocations and allocation
  retries since the previous chunk's read, or the start of the
  :meth:`Trainer.train` call) in its ``train`` row and its second
  ``qed.chunk.host`` span's arguments;
- the attempt journal (``engine/journal.py``): the first dispatch of each
  new step, graph, refine or eval configuration is recorded before it runs
  and marked ok after it completed, and a start refuses what a previous
  process died running (``_apply_crash_policy``, with ``journal_retry``'s
  amnesty); ``QED_CRASH_ONCE_AT=<step>`` kills the process once at that
  step, for the supervisor's tests (``cli train --supervise``).

The step updates parameters and moments in place, so every checkpoint,
pre-growth state and rollback target is a copy. Random draws come from
``torch.Generator``\\ s seeded from (seed, step); the camera order is the
datamanager's.

``vis`` set to ``tensorboard``, ``wandb`` or ``comet`` adds that writer
(``engine/writer.py``); ``vis="viewer"`` starts the live viewer
(``viewer.py``) on ``viewer_port``: it gets a snapshot of the params and
the metrics at every log, and its pause holds the loop between dispatches
(between chunks on the graph path). ``use_bilateral_grid`` trains one
colour grid per camera. ``TrainerConfig.mixed_precision`` turns on the
model's (the bf16 operand compositing kernels), as in the JAX trainer.

**The mesh** (``num_data_shards`` D x ``num_model_shards`` M > 1; the JAX
trainer's): one trainer a rank of a ``torch.distributed`` job of D * M
ranks (``cli train`` starts them, or ``torchrun``), ``parallel/mesh.py``.
Each step draws D cameras (``next_train_batch``, the same on every rank)
and runs ``parallel/dp.py``'s sharded step on the rank's camera and its
block of the gaussian rows, on the per-step loop (no graph: ``_use_scan``
is False, as in JAX). Refine, growth and the opacity reset run on the
gathered state, the same on every rank, which then keeps its rows again.
Rank 0 alone writes the metrics, the journal, checkpoints (the gathered
state, the single-device format) and runs eval and the viewer on the
gathered params; the other ranks wait at a barrier. The sharded step
returns no ``bbox_truncated``, so the pair budget never adapts under a
mesh, as in the JAX trainer. An out-of-memory error after a growth is not
reverted under a mesh (the rank dies and the job with it; the journal
refuses that capacity on the restart).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from qed_splatter_tpu_torch import cuda as qcuda
from qed_splatter_tpu_torch import resolve_device, tracing
from qed_splatter_tpu_torch.configs import TrainerConfig
from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine.densify import (
    DensifyStats,
    maybe_reset_opacities,
    refine,
)
from qed_splatter_tpu_torch.engine.journal import AttemptJournal
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.scan_runner import (
    DeviceDataset,
    make_scan_steps,
)
from qed_splatter_tpu_torch.engine.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
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
from qed_splatter_tpu_torch.models.splatfacto import (
    background_color,
    render,
    total_loss,
)
from qed_splatter_tpu_torch.parallel.dp import (
    gather_state,
    make_sharded_train_step,
    shard_state,
)
from qed_splatter_tpu_torch.parallel.mesh import (
    host_of_job,
    init_distributed,
    make_mesh,
)


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


# CUDA errors after which the context is unusable and the process must
# restart (the growth canary re-raises them; the journal witnesses them)
DEVICE_LOST = ("illegal memory access", "unspecified launch failure",
               "device-side assert", "an illegal instruction")


class _NoWriter:
    """The metrics writer of a rank other than 0: writes nothing."""

    def write(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, config: TrainerConfig,
                 datamanager: Optional[FullImageDatamanager] = None,
                 optims: Optional[GroupOptimizers] = None,
                 device="cuda"):
        if not config.data.data and datamanager is None:
            raise ValueError("TrainerConfig.data.data is required")
        self.config = config
        self.cfg = self._model_config(config)
        self.mesh = self._join_mesh(config, device)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        # the counters at the last chunk's metrics read (tracing on)
        self._counts: Optional[Dict[str, int]] = None
        # rank 0 writes metrics, journal and checkpoints, evals and serves
        self.is_writer = self.mesh is None or self.mesh.rank == 0
        host, hosts = host_of_job()
        by_host = config.shard_views_by_process
        self.dm = datamanager or FullImageDatamanager(
            config.data, seed=config.seed,
            process_index=host if by_host else 0,
            process_count=hosts if by_host else 1)
        self.optims = optims or GroupOptimizers(config.optimizers)
        self.run_dir = (Path(config.output_dir)
                        / (config.experiment_name or "qed-splatter"))
        self.writer = MetricsWriter(
            self.run_dir, console_every=config.log_every,
            use_tensorboard=config.vis == "tensorboard",
            use_wandb=config.vis == "wandb",
            use_comet=config.vis == "comet") if self.is_writer else \
            _NoWriter()
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
        # multi-step dispatch: frames on the device by downscale, and the
        # runners (one CUDA graph each) of the current bucket and capacity
        self._datasets: Dict[int, DeviceDataset] = {}
        self._runners: Dict[Tuple, object] = {}
        # the crash journal: configurations whose first dispatch completed
        # in this process, and the caps learned from crashes
        self._journal = AttemptJournal(self.run_dir / "attempt_journal.jsonl")
        self._witnessed: set = set()
        self._k_crash_cap: Dict[int, int] = {}
        self._eval_k_cap: Optional[int] = None
        self.state = self._setup_state()
        # the camera queue lives across train() calls, derived from the
        # resume step (multi-scene turns and resumes do not replay a prefix)
        self._reseed_sampling()
        self._apply_crash_policy()
        self.viewer = None
        if config.vis == "viewer" and self.is_writer:
            from qed_splatter_tpu_torch.viewer import Viewer

            self.viewer = Viewer(self.cfg, port=config.viewer_port,
                                 device=self.device)
            # the state the run starts from is viewable before step 1
            self.viewer.update(self.state.params, self.state.step)
            self.viewer.start()
        if self.mesh is not None:
            self.state = shard_state(self.state, self.mesh)
            # every rank read the journal before rank 0 writes to it
            self.mesh.barrier()

    # ------------------------------------------------------------ setup

    @staticmethod
    def _join_mesh(config: TrainerConfig, device):
        """This rank's mesh when D x M > 1 (joining the job the environment
        describes), else None."""
        n = config.num_data_shards * config.num_model_shards
        if n == 1:
            return None
        dev = init_distributed(device)
        if dev is None:
            raise RuntimeError(
                f"num_data_shards x num_model_shards = {n} needs {n} ranks: "
                "run `cli train`, which starts them, or torchrun")
        mesh = make_mesh(config.num_data_shards, config.num_model_shards,
                         device=dev)
        print(f"mesh {mesh.num_data}x{mesh.num_model}: rank {mesh.rank} "
              f"(data {mesh.data_index}, model {mesh.model_index}) on "
              f"{mesh.device}, backend {mesh.backend}", flush=True)
        return mesh

    def _full_state(self) -> TrainState:
        """The whole state: gathered from the model peers under a mesh
        (every rank of the mesh must call it)."""
        if self.mesh is None:
            return self.state
        return gather_state(self.state, self.mesh)

    def _as_writer(self, fn, *args):
        """``fn(*args)``; under a mesh on rank 0 with ``self.state`` the
        gathered state for the call, while the other ranks wait at a
        barrier (every rank must call it)."""
        if self.mesh is None:
            return fn(*args)
        full, out = self._full_state(), None
        if self.is_writer:
            local, self.state = self.state, full
            try:
                out = fn(*args)
            finally:
                self.state = local
        self.mesh.barrier()
        return out

    def _eval_as_writer(self, fn, cur: int, d: int) -> None:
        """``fn(cur)``, an eval rendering at 1/``d``, as :meth:`_as_writer`
        runs it. The eval seeds bucket 1/``d``'s K (:meth:`_k_eval`), so
        every rank seeds it first, alike: the ranks' K tables stay one."""
        self._k_for(d)
        self._as_writer(fn, cur)

    def _restore(self, path) -> TrainState:
        """A checkpoint's state, as this rank holds it."""
        state = ckpt.restore_checkpoint(path, self.device)
        return state if self.mesh is None else shard_state(state, self.mesh)

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
        # one camera delta and one colour grid per camera of the scene
        return init_train_state(
            params, self.optims, num_cameras=len(scene.frames),
            use_bilateral_grid=self.cfg.use_bilateral_grid,
            bilateral_grid_shape=self.cfg.bilateral_grid_shape)

    def _reseed_sampling(self) -> None:
        """The multi-step loop's camera queue from (seed, current step): at
        setup and after a rollback."""
        self._np_rng = np.random.default_rng((self.config.seed,
                                              int(self.state.step)))
        self._queue: list = []

    # ------------------------------------------------- crash-proof dispatch

    def _apply_crash_policy(self) -> None:
        """Refuse, by the journal's evidence, what a previous process died
        running: a crashed capacity growth is refused, a crashed step caps
        its bucket's K, a crashed eval caps the eval K, anything else at
        the current capacity freezes densification and growth. A
        configuration that crashed at most ``journal_retry`` times is
        granted amnesty and attempted again (a single kill may have been
        another process's fault); crashing again refuses it on every later
        start."""
        retry = self.config.journal_retry
        for c, count in self._journal.crashed_with_counts():
            if count <= retry:
                print(f"CRASH POLICY: config {c} crashed {count}x (<= "
                      f"journal_retry={retry}); granting amnesty and "
                      f"attempting it again; a second crash refuses it")
                continue
            self._apply_one_crash(c)

    def _apply_one_crash(self, c: Dict) -> None:
        cap_now = self.state.params.capacity
        kind = c.get("kind", "?")
        if int(c.get("capacity", 0)) > cap_now:
            bad = int(c["capacity"])
            self._grow_refused.add(bad)
            print(f"CRASH POLICY: a previous run died executing {kind} at "
                  f"capacity {bad} (> restored {cap_now}); refusing growth "
                  f"to {bad} (journal {self._journal.path})")
        elif kind == "step" and "d" in c and "k" in c:
            d, k = int(c["d"]), int(c["k"])
            capped = max(k // 2, 128)
            self._k_crash_cap[d] = capped
            if self._k_by_d.get(d, 0) >= k:
                self._k_by_d[d] = capped
            print(f"CRASH POLICY: a previous run died executing the train "
                  f"step at 1/{d} res with K={k}; capping this bucket's "
                  f"max_per_tile at {capped}")
        elif kind == "eval" and "k" in c:
            self._eval_k_cap = max(int(c["k"]) // 2, 128)
            print(f"CRASH POLICY: a previous run died in an eval render at "
                  f"K={c['k']}; capping eval K at {self._eval_k_cap}")
        else:  # refine, or unknown, at the current capacity
            self._grow_refused.add(min(cap_now * 2, self.cfg.max_capacity))
            self._densify_frozen_until = (
                self.state.step + self.config.divergence_freeze_steps)
            print(f"CRASH POLICY: a previous run died executing {kind} at "
                  f"the current capacity {cap_now}; freezing densification "
                  f"until step {self._densify_frozen_until} and refusing "
                  f"further growth")

    def _dispatch_journaled(self, key: Dict, fn, *args):
        """``fn(*args)``; the first time ``key`` runs in this process it is
        journaled: attempt, the dispatch, its completion
        (``torch.cuda.synchronize``), ok. A configuration seen before runs
        with no overhead."""
        fkey = frozenset(key.items())
        # the journal is rank 0's
        is_new = self.is_writer and fkey not in self._witnessed
        if is_new:
            self._journal.attempt(**key)
        out = fn(*args)
        if is_new:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._journal.ok(**key)
            self._witnessed.add(fkey)
        return out

    @staticmethod
    def _device_lost(e: Exception) -> bool:
        """True for errors after which the process must restart: CUDA's
        context-killing errors."""
        s = f"{type(e).__name__}: {e}"
        return any(m in s for m in DEVICE_LOST)

    @classmethod
    def _canary_reverts(cls, e: Exception) -> bool:
        """An out-of-memory error the growth canary reverts (a lost device
        is re-raised for the supervisor instead)."""
        oom = (isinstance(e, torch.cuda.OutOfMemoryError)
               or "out of memory" in str(e))
        return oom and not cls._device_lost(e)

    def _test_crash_hook(self, step: int) -> None:
        """``QED_CRASH_ONCE_AT=<step>``: a hard process exit (no cleanup) the
        first time ``step`` is reached in this run directory, for the
        supervisor and journal tests."""
        at = os.environ.get("QED_CRASH_ONCE_AT")
        if not at:
            return
        marker = self.run_dir / ".crash_once_done"
        if step >= int(at) and not marker.exists():
            marker.write_text(str(step))
            print(f"TEST HOOK: simulating a lost process at step {step}",
                  flush=True)
            os._exit(41)

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

    def _get_sharded_step_fn(self, width, height, has_depth, has_mask,
                             capacity, need_absgrad=True):
        key = ("sharded", width, height, has_depth, has_mask, capacity,
               need_absgrad, self.cfg.max_per_tile,
               self.cfg.small_tiles_per_gaussian)
        if key not in self._step_fns:
            self._step_fns[key] = make_sharded_train_step(
                self.cfg, self.optims, width, height, self.mesh,
                has_depth=has_depth, has_mask=has_mask,
                need_absgrad=need_absgrad)
        return self._step_fns[key]

    def _prepare_sharded_batch(self, step: int, d: int):
        """The rank's cameras of step ``step``'s ``num_data_shards``
        (every rank draws the same ones and loads its own), stacked."""
        b_local = self.config.num_data_shards // self.mesh.num_data
        lo = self.mesh.data_index * b_local
        items = self.dm.next_train_batch(step, self.config.num_data_shards,
                                         keep=slice(lo, lo + b_local))
        parts = [self._prepare_batch(item, d) for item in items]
        batches = [b for b, *_ in parts]
        batch = {k: (torch.stack([bb[k] for bb in batches])
                     if k != "cam_idx" else [bb[k] for bb in batches])
                 for k in batches[0]}
        return (batch,) + parts[0][1:]

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
        t0 = time.perf_counter()
        print(f"Growing gaussian capacity {cap} -> {new_cap}")
        if self.mesh is None:   # no canary under a mesh
            self._canary = (cap, new_cap, ckpt.copy_state(self.state, "cpu"),
                            cur, max_hw)
        self.state = self._grown_state(self.state, new_cap)
        self.writer.write(self.state.step, {
            "capacity_before": cap, "capacity_after": new_cap,
            "ms": (time.perf_counter() - t0) * 1e3}, prefix="grow")
        return True

    def _revert_growth(self, cur: int, err: Exception) -> None:
        """The refine or step after a growth ran out of memory: restore the
        pre-growth state and refuse that capacity (its runners go too)."""
        pre_cap, new_cap, pre = self._canary[:3]
        self._runners = {k: r for k, r in self._runners.items()
                         if k[3] != new_cap}
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
        with tracing.span("qed.refine.densify", cur):
            params, opt_state, stats, info = self._dispatch_journaled(
                dict(kind="refine", capacity=s.params.capacity,
                     max_hw=int(max_hw)),
                lambda: refine(s.params, s.opt_state, s.stats, s.step,
                               self.cfg, num_train_data=self.dm.num_train,
                               max_hw=max_hw,
                               generator=self._generator(cur, 1)))
        with tracing.span("qed.refine.reset", cur):
            params, opt_state = maybe_reset_opacities(params, opt_state,
                                                      s.step, self.cfg)
        self.state = dataclasses.replace(s, params=params,
                                         opt_state=opt_state, stats=stats)
        return info

    def _callbacks(self, cur: int, max_hw: int) -> None:
        """Refine / eval / checkpoint cadences after step ``cur``."""
        cfgt = self.config
        if (cur > self.cfg.warmup_length and cur % self.cfg.refine_every == 0
                and cur >= self._densify_frozen_until):
            with tracing.span("qed.refine", cur):
                self._refine_cadence(cur, max_hw)
        d = self._downscale_factor(cur)
        if cfgt.steps_per_eval_image and cur % cfgt.steps_per_eval_image == 0:
            with tracing.span("qed.eval_image", cur):
                self._eval_as_writer(self.eval_image, cur, d)
        if cfgt.steps_per_eval_batch and cur % cfgt.steps_per_eval_batch == 0:
            self._eval_as_writer(self.eval_batch, cur, d)
        if (cfgt.steps_per_eval_all_images
                and cur % cfgt.steps_per_eval_all_images == 0):
            self._eval_as_writer(self.eval_all, cur, 1)
        if cfgt.steps_per_save and cur % cfgt.steps_per_save == 0:
            with tracing.span("qed.save", cur):
                self._save(self.run_dir / "ckpts", cur)
                # a rollback target only if the params are finite
                if self._state_finite():
                    self._good_ckpt = cur

    def _refine_cadence(self, cur: int, max_hw: int) -> None:
        """The growth check, refine and opacity reset of step ``cur``, with
        their wall ms in a ``refine`` row."""
        t0 = time.perf_counter()
        # under a mesh every rank refines the gathered state alike
        self.state = self._full_state()
        with tracing.span("qed.refine.grow_check", cur):
            self._maybe_grow(cur, max_hw)
        try:
            info = self._refine(cur, max_hw)
        except Exception as e:
            # the canary is set by this cadence's growth only
            if self._canary is None or not self._canary_reverts(e):
                raise
            self._revert_growth(cur, e)
            info = self._refine(cur, max_hw)
        if self.mesh is not None:
            self.state = shard_state(self.state, self.mesh)
        self.writer.write(cur, {**info._asdict(), "ms": (
            time.perf_counter() - t0) * 1e3}, prefix="refine")

    def _save(self, ckpt_dir: Path, step: int) -> Optional[Path]:
        """A checkpoint of the whole state (rank 0's, under a mesh)."""
        return self._as_writer(lambda: ckpt.save_checkpoint(
            ckpt_dir, self.state, step,
            dataparser_transform=self.dm.scene.transform_matrix,
            dataparser_scale=self.dm.scene.scale_factor,
            model_config=self.cfg, k_by_d=self._k_by_d,
            tpg_by_d=self._tpg_by_d))

    # ------------------------------------------------- divergence handling

    def _state_finite(self) -> bool:
        """The params canary: a fully poisoned model renders pure
        background with a finite loss, so the loss alone is not enough."""
        with tracing.span("qed.state_finite", self.state.step):
            p = self.state.params
            s = (p.means.sum() + p.scales.sum() + p.quats.sum()
                 + p.opacities.sum() + self.state.camera_opt.sum())
            if self.mesh is not None:   # one answer on every rank
                s = self.mesh.all_reduce(s, "mesh")
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
            self.state = self._restore(path)
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
        cap = self._k_crash_cap.get(d)
        if cap is not None and self._k_by_d[d] > cap:
            self._k_by_d[d] = cap
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
        # a K that killed a previous run caps the bucket below it
        k_limit = min(cfg.max_per_tile_limit,
                      self._k_crash_cap.get(d, cfg.max_per_tile_limit))
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

    def _viewer_gate(self) -> None:
        """Block between dispatches while the viewer has training paused."""
        if self.viewer is None:
            return
        while self.viewer.state.paused:
            time.sleep(0.05)

    # ------------------------------------------------- multi-step dispatch

    def _dispatch_chunk(self) -> int:
        """Steps per dispatch: explicit, or the gcd of every step cadence
        (capped at 100), so each cadence falls on a chunk's end."""
        if self.config.steps_per_dispatch:
            return self.config.steps_per_dispatch
        cads = [self.cfg.refine_every, self.cfg.warmup_length,
                self.cfg.resolution_schedule, self.cfg.stop_split_at,
                self.cfg.stop_screen_size_at,
                self.config.steps_per_eval_image,
                self.config.steps_per_eval_all_images,
                self.config.steps_per_save, self.config.max_num_iterations,
                self.config.log_every]
        g = 0
        for c in cads:
            if c:
                g = math.gcd(g, int(c))
        return max(1, min(g or 1, 100))

    def _use_scan(self) -> bool:
        """Multi-step dispatch unless under a mesh, ``steps_per_dispatch=1``,
        a chunk of 1, or an image cache (every train frame and its depth,
        twice for the downscale buckets) above ``max_device_cache_bytes``."""
        if (self.mesh is not None or self.config.steps_per_dispatch == 1
                or self._dispatch_chunk() <= 1):
            return False
        item = self.dm.get_item(int(self.dm.train_indices[0]))
        per = item["image"].nbytes + (
            item["depth_image"].nbytes if "depth_image" in item else 0)
        return per * self.dm.num_train * 2 <= (
            self.config.max_device_cache_bytes)

    def _device_dataset(self, d: int) -> DeviceDataset:
        if d not in self._datasets:
            items = [self.dm.get_item(int(i)) for i in self.dm.train_indices]
            self._datasets[d] = DeviceDataset(items, d, downscale_image,
                                              downscale_depth, self.device)
        return self._datasets[d]

    def _get_scan_fn(self, d: int, chunk: int, need_absgrad: bool,
                     capacity: int):
        """(runner, dataset) of ``chunk`` steps at 1/``d`` res. A runner is
        one CUDA graph: a new key is a new capture, and the runners of
        another bucket or capacity (which the schedule does not return
        to) are dropped with their graphs."""
        ds = self._device_dataset(d)
        key = (d, chunk, need_absgrad, capacity, self.cfg.max_per_tile,
               self.cfg.small_tiles_per_gaussian, ds.has_depth, ds.has_mask,
               self.cfg.camera_opt_mode != "off")
        if key not in self._runners:
            self._runners = {k: r for k, r in self._runners.items()
                             if (k[0], k[3]) == (d, capacity)}
            self._runners[key] = make_scan_steps(
                self.cfg, self.optims, ds, chunk, need_absgrad=need_absgrad,
                device=self.device)
        return self._runners[key], ds

    def _next_perm(self, n: int) -> list:
        """The next ``n`` train positions of the queue: epochs of random
        permutations without replacement, as the JAX trainer draws them."""
        while len(self._queue) < n:
            self._queue.extend(
                self._np_rng.permutation(self.dm.num_train).tolist())
        perm, self._queue = self._queue[:n], self._queue[n:]
        return perm

    def _backgrounds(self, step: int, n: int) -> Optional[torch.Tensor]:
        """[n, 3] random backgrounds of steps ``step`` .. ``step + n - 1``,
        drawn from the per-step loop's generators (None for a fixed
        colour)."""
        if self.cfg.background_color != "random":
            return None
        return torch.stack([background_color(self.cfg, self.device, True,
                                             self._generator(step + i, 0))
                            for i in range(n)])

    def _train_scan(self, max_steps: Optional[int] = None,
                    finalize: bool = True) -> TrainState:
        """Multi-step dispatch: one runner call (a CUDA graph replayed per
        step on CUDA) per chunk, cameras from the epoch-permutation queue,
        one metrics row per chunk."""
        cfgt = self.config
        total = max_steps or cfgt.max_num_iterations
        chunk = self._dispatch_chunk()
        start_step = self.state.step
        t0 = time.perf_counter()
        step = start_step
        self._counts = (tracing.counters(self.device) if tracing.enabled()
                        else None)
        # the profiler's window: the first chunk that starts at or after
        # start + 10, with its callbacks
        prof, traced = None, not cfgt.profile_dir or not self.is_writer
        while step < total:
            if prof is not None:
                self._stop_profile(prof, prof_from, step)
                prof = None
            if not traced and step >= start_step + 10:
                # a replayed chunk runs few host operators: their shapes
                # cost little, and the spans' arguments come with them
                prof, traced, prof_from = self._start_profile(True), True, step
            with tracing.span("qed.chunk", step):
                step = self._scan_chunk(step, total, chunk)
        if prof is not None:
            self._stop_profile(prof, prof_from, step)
        self._report(total - start_step, t0, f", chunk={chunk}")
        if finalize:
            self.finalize(total)
        return self.state

    def _scan_chunk(self, step: int, total: int, chunk: int) -> int:
        """One chunk from ``step`` and the host work after it; returns the
        step to go on from."""
        with tracing.span("qed.chunk.host", step):
            self._viewer_gate()
            n = min(chunk, total - step)
            d = self._downscale_factor(step)
            self._sync_bucket_cfg(d)
            perm = self._next_perm(n)
            runner, ds = self._get_scan_fn(
                d, n, need_absgrad=step < self.cfg.stop_split_at,
                capacity=self.state.params.capacity)
            jrec = dict(kind="step", capacity=self.state.params.capacity,
                        d=int(d), k=int(self.cfg.max_per_tile), chunk=int(n),
                        tpg=int(self.cfg.small_tiles_per_gaussian),
                        absgrad=bool(step < self.cfg.stop_split_at))
            bgs = self._backgrounds(step, n)
        try:
            self.state, metrics = self._dispatch_journaled(
                jrec, runner, self.state, perm, bgs)
        except Exception as e:
            if self._canary is None or not self._canary_reverts(e):
                raise
            refine_at = self._canary[3:]
            self._revert_growth(step, e)
            info = self._refine(*refine_at)
            self.writer.write(refine_at[0], info._asdict(), prefix="refine")
            return step
        first, step = step, step + n
        delta = {}
        if tracing.enabled():
            # what ran since the previous chunk's read: its callbacks, this
            # chunk's capture and replays
            now = tracing.counters(self.device)
            if self._counts is not None:
                delta = {k: v - self._counts.get(k, 0) for k, v in now.items()}
            self._counts = now
        with tracing.span("qed.chunk.host", first, *delta.values()):
            self._canary = None
            self._test_crash_hook(step)
            # one host read per chunk; reductions over the chunk, not only
            # its last step, so a spike or a first NaN inside it shows
            marr = dict(zip(runner.names, metrics.cpu().numpy().T))
            marr.pop("cam_idx")
            with tracing.span("qed.adapt", first):
                last = {k: float(v[-1]) for k, v in marr.items()}
                last["gaussian_count"] = int(self.state.params.num_alive())
                last["loss_max"] = float(np.max(marr["loss"]))
                if "nonfinite_grads" in marr:
                    last["nonfinite_grads"] = float(np.sum(
                        marr["nonfinite_grads"]))
                last.update(delta)
                self._maybe_adapt_k(float(np.max(marr["tile_overflow"])),
                                    float(np.max(marr["tile_max_count"])),
                                    ds.width, ds.height, d)
                self._maybe_adapt_tpg(last.get("bbox_truncated"), d)
                self.writer.write(step, last, prefix="train")
            if self.viewer is not None:
                self.viewer.update(self.state.params, step, metrics=last)
            if (not bool(np.isfinite(marr["loss"]).all())
                    or not self._state_finite()):
                step = self._handle_divergence(step)
                self._reseed_sampling()
                return step
            self._callbacks(step, max(ds.width, ds.height))
        return step

    def _report(self, done: int, t0: float, extra: str = "") -> None:
        if done > 0:
            wall = time.perf_counter() - t0
            print(f"Trained {done} steps in {wall:.1f}s "
                  f"({done / max(wall, 1e-9):.2f} iters/s{extra})")

    # ------------------------------------------------------------- loop

    def train(self, max_steps: Optional[int] = None,
              finalize: bool = True) -> TrainState:
        """Train to ``max_steps`` (default: the configured budget), then
        ``finalize`` unless told not to; multi-step dispatch where
        :meth:`_use_scan` picks it, else the per-step loop; with
        ``profile_dir``, tracing on for the call."""
        with tracing.on(bool(self.config.profile_dir)), \
                tracing.span("qed.train", self.state.step):
            if self._use_scan():
                return self._train_scan(max_steps, finalize)
            return self._train_per_step(max_steps, finalize)

    def _train_per_step(self, max_steps: Optional[int] = None,
                        finalize: bool = True) -> TrainState:
        cfgt = self.config
        total = max_steps or cfgt.max_num_iterations
        start_step = self.state.step
        t0 = time.perf_counter()
        step = start_step
        # the loss of step N is read after step N + 1 ran
        prev_loss = None
        # the profiler's window, the JAX trainer's: steps start + 10 to
        # start + 14 (once, whatever a rollback does to the step)
        # (rank 0's alone under a mesh)
        prof, traced = None, not cfgt.profile_dir or not self.is_writer
        while step < total:
            self._viewer_gate()
            if not traced and step == start_step + 10:
                prof, traced = self._start_profile(), True
            d = self._downscale_factor(step)
            self._sync_bucket_cfg(d)
            if self.mesh is None:
                item = self.dm.next_train(step)
                batch, cam, has_depth, has_mask = self._prepare_batch(item,
                                                                      d)
                get_step = self._get_step_fn
            else:
                batch, cam, has_depth, has_mask = \
                    self._prepare_sharded_batch(step, d)
                get_step = self._get_sharded_step_fn
            capacity = self.state.params.capacity * (
                self.mesh.num_model if self.mesh is not None else 1)
            step_fn = get_step(
                cam.width, cam.height, has_depth, has_mask,
                self.state.params.capacity,
                # absgrad stats matter only while densification can run
                need_absgrad=step < self.cfg.stop_split_at)
            jrec = dict(kind="step", capacity=capacity,
                        d=int(d), k=int(self.cfg.max_per_tile),
                        w=int(cam.width), h=int(cam.height),
                        sharded=self.mesh is not None)
            try:
                self.state, metrics = self._dispatch_journaled(
                    jrec, step_fn, self.state, batch,
                    self._generator(step, 0))
            except Exception as e:
                if self._canary is None or not self._canary_reverts(e):
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
            self._test_crash_hook(cur)
            if prof is not None and cur == start_step + 15:
                self._stop_profile(prof, start_step + 10, cur)
                prof = None

            if prev_loss is not None and not math.isfinite(float(prev_loss)):
                step = self._handle_divergence(cur - 1)
                self._reseed_sampling()
                prev_loss = None
                continue
            prev_loss = metrics["loss"]

            if cur % cfgt.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                self.writer.write(cur, host, prefix="train")
                if self.config.vis == "viewer":
                    # every rank gathers; rank 0 holds the viewer
                    params = self._full_state().params
                    if self.viewer is not None:
                        self.viewer.update(params, cur, metrics=host)
                self._maybe_adapt_k(host.get("tile_overflow"),
                                    host.get("tile_max_count"),
                                    cam.width, cam.height, d)
                self._maybe_adapt_tpg(host.get("bbox_truncated"), d)
                if not math.isfinite(host["loss"]) or not self._state_finite():
                    step = self._handle_divergence(cur)
                    self._reseed_sampling()
                    prev_loss = None
                    continue
            self._callbacks(cur, max(cam.width, cam.height))

        if prof is not None:
            self._stop_profile(prof, start_step + 10, step)
        self._report(total - start_step, t0)
        if finalize:
            self.finalize(total)
        return self.state

    def _start_profile(self, record_shapes: bool = False):
        """A started profiler; ``record_shapes`` keeps the spans' arguments
        (and every operator's input shapes) in its trace."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, record_shapes=record_shapes)
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
        """End-of-training checkpoint (with both adaptive tables),
        ``splat.ply`` and ``kernel_launches.json`` (rank 0's, under a
        mesh)."""
        self._save(self.run_dir / "ckpts",
                   total if total is not None else self.state.step)
        self._as_writer(self._finalize_files)

    def _finalize_files(self) -> None:
        meta = ckpt.checkpoint_meta(self.run_dir / "ckpts")
        ckpt.export_ply(self.run_dir / "splat.ply", self.state.params, meta)
        (self.run_dir / "kernel_launches.json").write_text(json.dumps({
            k.symbol + "".join(k.defines): {
                "launches": k.launches, "variants": k.variant_launches}
            for k in qcuda.KERNELS if k.launches}))

    # -------------------------------------------------------------- eval

    def _k_eval(self, d: int) -> int:
        """K for eval renders: the max adaptive K over all buckets (eval
        views get no overflow feedback and a shrunk K could truncate),
        under the cap a crashed eval left."""
        k = max([self._k_for(d), *self._k_by_d.values()])
        if self._eval_k_cap is not None:
            k = min(k, self._eval_k_cap)
        return k

    def _render_eval(self, item: Dict, d: int = 1):
        cam = item["camera"].rescaled(1.0 / d) if d > 1 else item["camera"]
        k = self._k_eval(d)
        # the largest escalated pair budget: eval never bbox-truncates more
        # than training
        tpg = max([self.config.model.small_tiles_per_gaussian,
                   *self._tpg_by_d.values()])
        k_limit = min(self.cfg.max_per_tile_limit,
                      self._eval_k_cap or self.cfg.max_per_tile_limit)
        while True:
            eval_cfg = dataclasses.replace(self.cfg, max_per_tile=k,
                                           small_tiles_per_gaussian=tpg)
            out = self._dispatch_journaled(
                dict(kind="eval", capacity=self.state.params.capacity,
                     k=int(k), w=int(cam.width), h=int(cam.height)),
                lambda: render(self.state.params, cam.c2w,
                               cam.intrinsics_matrix(), cam.width,
                               cam.height, eval_cfg, step=self.state.step,
                               train=False, device=self.device))
            # re-render once at a doubled K (to the limit) when the
            # per-tile lists truncated, for an unbiased metric
            if int(out.tile_overflow) > 0 and k < k_limit:
                k = min(k * 2, k_limit)
                continue
            return out, cam

    def _tag_eval_k_cap(self, metrics: Dict) -> None:
        """A crash-capped eval K goes into the metrics row: its renders may
        truncate, so the metrics are lower bounds."""
        if self._eval_k_cap is not None:
            metrics["eval_k_cap"] = int(self._eval_k_cap)
            print(f"WARNING: eval K crash-capped at {self._eval_k_cap}; "
                  f"eval renders may truncate, metrics are lower bounds")

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
        self._tag_eval_k_cap(metrics)
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
        self._tag_eval_k_cap(agg)
        self.writer.write(step, agg, prefix="eval_all", force_console=True)
        return agg
