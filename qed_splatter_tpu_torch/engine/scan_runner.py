"""Device-resident dataset and multi-step dispatch as a CUDA graph of the
step (port of ``engine/scan_runner.py``).

The JAX package runs a chunk of steps inside one jitted ``lax.scan`` that
samples cameras from a uint8 image cache on the device. PyTorch's form of
one dispatch for many steps is a CUDA graph: the step's body
(``TrainStep.run``, which is capture-clean) is captured once and replayed
once per step of the chunk. The host then issues none of the step's
hundreds of launches. Every per-step input lives in a buffer at a fixed
address that the runner or its step holds (a graph keeps none of the
tensors it reads alive: SSIM's band matrices are the step's own), and the
body reads it by a device position counter:

- the chunk's camera order (``perm``) and backgrounds (drawn ahead, from
  the per-step seeds the per-step loop uses);
- the bucket's frames (:class:`DeviceDataset`), uint8 RGB converted to
  float in the body;
- the step counter, which the body increments;
- the metrics, one row per step in an ``[n, M]`` buffer (the scan's stacked
  metrics), read once per chunk.

A chunk's first step runs eagerly, on the capture's side stream, under the
sync debug mode "error": it is a real step and the warm-up (lazy kernel
loads, cuBLAS handles and the allocator's first blocks happen outside the
capture). The body is captured after it and replayed for steps 2..n; later
chunks replay all n. A capture that fails raises. On a CPU device the same
body runs eagerly; nothing else differs.

A capture is in the global capture mode, where a CUDA call from another
thread can invalidate it: every warm-up and capture holds
:data:`CAPTURE_LOCK`, and other threads that use the card beside training
(the viewer's renders) take it around their device work.

The graph reads and writes the state's tensors at the addresses it saw at
capture. A refine, a rollback or a resume hands the runner other tensors:
it compares ``data_ptr()``s and copies them into its own before the next
replay (a growth changes the capacity, and so the runner). The caller's
state is then the runner's tensors.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from qed_splatter_tpu_torch import cuda as qcuda
from qed_splatter_tpu_torch import resolve_device, tracing
from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.engine.densify import DensifyStats
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import (
    StepInputs,
    TrainState,
    TrainStep,
    make_train_step,
)
from qed_splatter_tpu_torch.models.gaussians import FIELDS
from qed_splatter_tpu_torch.models.splatfacto import background_color

# the per-step metrics a chunk keeps (the JAX scan's stacked ``light``
# dict, and the grids' ``tv_loss`` and ``bilagrid_clamped`` where the step
# has them), then the camera index each step read
LIGHT = ("loss", "psnr", "main_loss", "depth_loss", "tile_overflow",
         "bbox_truncated", "tile_max_count", "nonfinite_grads", "tv_loss",
         "bilagrid_clamped")

# uint8 -> float32 / 255 as one IEEE division per value (numpy's, and the
# per-step loop's), looked up in the body
_U8_TO_UNIT = np.arange(256, dtype=np.float32) / np.float32(255.0)


def _device_array(x: np.ndarray, device) -> torch.Tensor:
    """``jnp.asarray`` without x64: float64 -> float32, int64 -> int32."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    elif x.dtype == np.int64:
        x = x.astype(np.int32)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


class DeviceDataset:
    """One resolution bucket's training frames stacked on the device:
    ``rgb_u8`` [N, H, W, 3] uint8, ``c2w`` [N, 3or4, 4], ``K`` [N, 3, 3],
    ``cam_idx`` [N] int32, and ``depth`` [N, H, W, 1] / ``mask`` where
    every item has them (the JAX ``DeviceDataset``'s fields, dtypes and
    downscale: box-averaged RGB cast to uint8, nearest-sample depth and
    mask)."""

    def __init__(self, items, d: int, downscale_image, downscale_depth,
                 device="cuda"):
        dev = resolve_device(device)
        cams, rgbs, depths, masks, c2ws, Ks, idxs = [], [], [], [], [], [], []
        for item in items:
            cam = item["camera"].rescaled(1.0 / d) if d > 1 else item["camera"]
            cams.append(cam)
            rgbs.append(np.asarray(downscale_image(item["image"], d),
                                   np.uint8)
                        if d > 1 else item["image"])
            c2ws.append(cam.c2w)
            Ks.append(cam.intrinsics_matrix())
            idxs.append(item["cam_idx"])
            if "depth_image" in item:
                depths.append(downscale_depth(item["depth_image"], d))
            if "mask" in item:
                masks.append(downscale_depth(item["mask"], d))
        self.width, self.height = cams[0].width, cams[0].height
        self.has_depth = len(depths) == len(items)
        self.has_mask = len(masks) == len(items)
        self.data: Dict[str, torch.Tensor] = {
            "rgb_u8": _device_array(np.stack(rgbs), dev),
            "c2w": _device_array(np.stack(c2ws), dev),
            "K": _device_array(np.stack(Ks), dev),
            "cam_idx": _device_array(np.asarray(idxs, np.int32), dev),
        }
        if self.has_depth:
            self.data["depth"] = _device_array(np.stack(depths), dev)
        if self.has_mask:
            self.data["mask"] = _device_array(np.stack(masks), dev)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())


def _map_state(state: TrainState, fn) -> TrainState:
    """``state`` with each tensor ``x`` replaced by ``fn(x)``, in a fixed
    order: params, opt_state (by group), camera_opt, its Adam state,
    stats, then the bilateral grids and their Adam state where the state
    has them."""
    def adam(s):
        return {k: fn(s[k]) for k in ("count", "mu", "nu")}

    params = dataclasses.replace(
        state.params, **{f: fn(getattr(state.params, f)) for f in FIELDS})
    opt_state = {g: adam(state.opt_state[g]) for g in sorted(state.opt_state)}
    camera_opt = fn(state.camera_opt)
    camera_opt_state = adam(state.camera_opt_state)
    stats = DensifyStats(*(fn(getattr(state.stats, f.name))
                           for f in dataclasses.fields(DensifyStats)))
    grids = gstate = None
    if state.bilateral_grids is not None:
        grids = fn(state.bilateral_grids)
        gstate = adam(state.bilateral_grid_state)
    return dataclasses.replace(state, params=params, opt_state=opt_state,
                               camera_opt=camera_opt,
                               camera_opt_state=camera_opt_state, stats=stats,
                               bilateral_grids=grids,
                               bilateral_grid_state=gstate)


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_state(state, lambda x: out.append(x) or x)
    return out


# held across each warm-up and capture; see the module docstring
CAPTURE_LOCK = threading.Lock()

_POOLS: Dict[int, tuple] = {}
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def graph_pool(device) -> tuple:
    """The memory pool every graph on ``device`` captures into. Sharing it
    is safe: graphs run one at a time on one stream, and no graph output
    lives in the pool. Every tensor the body keeps (the state, the metrics
    buffer, the counters, the inputs) was allocated before the capture, so
    what a capture leaves in the pool is workspace that the next replay of
    any graph writes before it reads."""
    idx = _index(device)
    if idx not in _POOLS:
        _POOLS[idx] = torch.cuda.graph_pool_handle()
    return _POOLS[idx]


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream every warm-up and capture on ``device`` runs on: the
    caching allocator reuses a freed block only on the stream that
    allocated it, so one stream lets each capture reuse the workspace the
    pool's earlier captures freed."""
    idx = _index(device)
    if idx not in _STREAMS:
        _STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _STREAMS[idx]


def pool_bytes(pool, device) -> Optional[int]:
    """Bytes of the allocator's segments in ``pool`` (None where the
    allocator's snapshot does not name pools)."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    idx = _index(device)
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool)
               and s.get("device", idx) == idx)


def _launch_counts():
    return [(k, k.launches, dict(k.variant_launches)) for k in qcuda.KERNELS]


def _launch_delta(before):
    out = []
    for k, n0, v0 in before:
        dv = {v: n - v0.get(v, 0) for v, n in k.variant_launches.items()
              if n != v0.get(v, 0)}
        if k.launches != n0 or dv:
            out.append((k, k.launches - n0, dv))
    return out


class ScanRunner:
    """``runner(state, perm, backgrounds=None) -> (state, metrics)``: the
    ``n`` steps of a chunk on the cameras ``perm`` ([n] positions into the
    dataset), returning the state at step + n (the runner's tensors on
    CUDA) and the ``[n, M]`` metrics buffer (columns :attr:`names`; it is
    overwritten by the next chunk). ``backgrounds`` ([n, 3] on the device)
    is needed with a random background.

    On CUDA one graph per runner; its replays add the launches its capture
    recorded to the kernels' counts (a host call counts one, a replay
    launches without one). :attr:`captures` / :attr:`replays` count both
    (and, with tracing on, ``tracing.COUNTS`` the captures). With tracing
    on, each call is a ``qed.chunk.bind`` span, a ``qed.capture`` where it
    captures and a ``qed.chunk.replay`` span (the eager body on the
    CPU)."""

    def __init__(self, step: TrainStep, dataset: DeviceDataset, n: int,
                 pool=None):
        dev = step.device
        self.step, self.dataset, self.n, self.device = step, dataset, n, dev
        self.graphed = dev.type == "cuda"
        self.pool = pool
        self.random_bg = step.cfg.background_color == "random"
        self._fixed_bg = (None if self.random_bg else
                          background_color(step.cfg, dev, train=True))
        self._unit = torch.as_tensor(_U8_TO_UNIT, device=dev)
        self._perm = torch.zeros(n, dtype=torch.int64, device=dev)
        self._bg = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        self._pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.step_counter = torch.zeros((), dtype=torch.int32, device=dev)
        self.names: Optional[List[str]] = None
        self.metrics: Optional[torch.Tensor] = None   # [n, M]
        self._graph = None
        self._bound: Optional[List[torch.Tensor]] = None
        self._replay_launches: list = []
        self.captures = self.replays = 0

    @tracing.step_body
    def _body(self, state: TrainState) -> None:
        """One step at position ``_pos`` of the chunk: the camera
        ``perm[pos]`` from the dataset, then ``TrainStep.run``, its metrics
        into row ``pos``; ``pos`` and the step counter + 1."""
        tracing.stage("step.inputs")
        data, pos = self.dataset.data, self._pos
        sel = self._perm.index_select(0, pos)

        def row(x):
            return x.index_select(0, sel)[0]

        cam_idx = data["cam_idx"].index_select(0, sel)
        u8 = row(data["rgb_u8"])
        inp = StepInputs(
            c2w=row(data["c2w"]), K=row(data["K"]), cam_idx=cam_idx,
            rgb=self._unit.index_select(0, u8.reshape(-1).long()).reshape(
                u8.shape),
            depth=row(data["depth"]) if self.step.has_depth else None,
            mask=row(data["mask"]) if self.step.has_mask else None,
            background=(self._bg.index_select(0, pos)[0] if self.random_bg
                        else self._fixed_bg),
            step=self.step_counter)
        m = self.step.run(state, inp)
        m["cam_idx"] = cam_idx[0]
        if self.names is None:      # the first (eager) step: never captured
            self.names = [k for k in LIGHT if k in m] + ["cam_idx"]
            self.metrics = torch.zeros((self.n, len(self.names)),
                                       dtype=torch.float32, device=self.device)
        vals = torch.stack([m[k].to(torch.float32).reshape(())
                            for k in self.names])
        self.metrics.index_copy_(0, pos, vals[None])
        pos.add_(1)
        tracing.stage("step.end")

    def _bind(self, state: TrainState) -> TrainState:
        """``state`` on the tensors the graph was captured on: the first
        state's own, later ones copied in where their addresses differ."""
        leaves = state_tensors(state)
        if self._bound is None:
            self._bound = leaves
            return state
        if len(leaves) != len(self._bound):
            raise ValueError("the state's structure changed under a graph")
        for b, x in zip(self._bound, leaves):
            if b.data_ptr() != x.data_ptr():
                if b.shape != x.shape or b.dtype != x.dtype:
                    raise ValueError(
                        f"a state tensor changed from {tuple(b.shape)} "
                        f"{b.dtype} to {tuple(x.shape)} {x.dtype} under a "
                        "graph (a new capacity needs a new runner)")
                b.copy_(x)
        it = iter(self._bound)
        return _map_state(state, lambda _: next(it))

    def _capture(self, state: TrainState) -> None:
        """Step 1 eagerly on a side stream (the warm-up), then the capture
        of the body; neither may sync with the host, and no other thread
        may use the card meanwhile (:data:`CAPTURE_LOCK`)."""
        with CAPTURE_LOCK, tracing.span("qed.capture", state.step):
            self._capture_locked(state)

    def _capture_locked(self, state: TrainState) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body(state)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body(state)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        # the capture's calls launched nothing: take them back, and add
        # them on every replay instead
        self._replay_launches = _launch_delta(before)
        for k, n, v in self._replay_launches:
            k.add(-n, {name: -c for name, c in v.items()})
        self._graph = graph
        self.captures += 1
        if tracing.enabled():
            tracing.COUNTS["graph_captures"] += 1

    def __call__(self, state: TrainState, perm,
                 backgrounds: Optional[torch.Tensor] = None):
        perm = np.asarray(perm, np.int64).reshape(-1)
        if perm.shape[0] != self.n:
            raise ValueError(f"perm has {perm.shape[0]} steps, the runner "
                             f"{self.n}")
        if self.random_bg and backgrounds is None:
            raise ValueError("a random background needs the chunk's "
                             "backgrounds")
        with tracing.span("qed.chunk.bind", state.step):
            self._perm.copy_(torch.as_tensor(perm))
            if self.random_bg:
                self._bg.copy_(backgrounds)
            self._pos.zero_()
            self.step_counter.fill_(state.step)
            if self.graphed:
                state = self._bind(state)
        if not self.graphed:
            with tracing.span("qed.chunk.replay", state.step):
                for _ in range(self.n):
                    self._body(state)
        else:
            replays = self.n
            if self._graph is None:
                self._capture(state)
                replays -= 1
            with tracing.span("qed.chunk.replay", state.step):
                for _ in range(replays):
                    self._graph.replay()
            self.replays += replays
            for k, n, v in self._replay_launches:
                k.add(n * replays, {name: c * replays
                                    for name, c in v.items()})
        return dataclasses.replace(state, step=state.step + self.n), \
            self.metrics


def make_scan_steps(cfg: ModelConfig, optims: GroupOptimizers,
                    dataset: DeviceDataset, num_steps: int,
                    need_absgrad: bool = True,
                    camera_opt_on: Optional[bool] = None,
                    device="cuda") -> ScanRunner:
    """Runner: ``(state, perm [num_steps], backgrounds) -> (state, metrics
    [num_steps, M])``, a CUDA graph of the step on CUDA (one pool per
    device) and the same body run eagerly on the CPU."""
    dev = resolve_device(device)
    step = make_train_step(
        cfg, optims, dataset.width, dataset.height,
        has_depth=dataset.has_depth, has_mask=dataset.has_mask,
        camera_opt_on=camera_opt_on, need_absgrad=need_absgrad, device=dev)
    pool = graph_pool(dev) if dev.type == "cuda" else None
    return ScanRunner(step, dataset, num_steps, pool)
