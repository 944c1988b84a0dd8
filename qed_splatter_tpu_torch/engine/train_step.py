"""The training step: render -> loss -> backward -> Adam -> stats (port of
``engine/train_step.py``).

One call does, for one camera, in the JAX step's order:

- the training render with the camera-opt delta applied; with
  ``use_bilateral_grid``, the camera's colour grid applied to it and the
  result clipped to [0, 1] (the metric ``bilagrid_clamped``: the share of
  channel values the clip cuts);
- :func:`~qed_splatter_tpu_torch.models.splatfacto.total_loss` plus the
  camera-opt regularizer and ``10 * total_variation_loss`` of the grids;
- gradients to the six gaussian groups, the camera deltas, the grids and
  the absgrad side channel (the compositing backward kernel on CUDA
  tensors);
- the count and zeroing of non-finite gradient elements, then the optional
  global-norm clip, before any optimizer state is touched;
- the per-group Adam, then the camera Adam, then the grids' Adam (group
  ``bilateral_grid``);
- the densification statistics.

Parameters, Adam moments and counts and the statistics are updated **in
place**: the returned :class:`TrainState` holds the same tensors as the one
passed in, with the next step. The body (:meth:`TrainStep.run`) is
capture-clean, so ``engine/scan_runner.py`` replays it as a CUDA graph.
With tracing on, the body marks its stages (``tracing.STAGES``) on the
device.
``cfg.mixed_precision`` takes the
bf16 operand compositing kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from qed_splatter_tpu_torch import resolve_device, tracing
from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.engine.densify import DensifyStats, \
    accumulate_stats_
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers, adam_init
from qed_splatter_tpu_torch.models.bilateral_grid import (
    apply_bilateral_grid,
    init_bilateral_grids,
    total_variation_loss,
)
from qed_splatter_tpu_torch.models.camera_opt import (
    apply_camera_opt,
    camera_opt_regularizer,
)
from qed_splatter_tpu_torch.models.gaussians import (
    FIELDS,
    GROUPS,
    GaussianParams,
)
from qed_splatter_tpu_torch.models.splatfacto import (
    background_color,
    render,
    total_loss,
)
from qed_splatter_tpu_torch.ops.rasterize import absgrad_scatter
from qed_splatter_tpu_torch.ops.ssim import ssim_bands


@dataclasses.dataclass
class TrainState:
    """Everything the step updates."""

    params: GaussianParams
    opt_state: Dict                # group -> {"count", "mu", "nu"}
    camera_opt: torch.Tensor       # [num_cameras, 6] SO3xR3 deltas
    camera_opt_state: Dict         # {"count", "mu", "nu"} of camera_opt
    stats: DensifyStats
    step: int
    # per-camera colour grids [num_cameras, gh, gw, gd, 12] and their Adam
    # state; None when the bilateral grid is off
    bilateral_grids: Optional[torch.Tensor] = None
    bilateral_grid_state: Optional[Dict] = None


def init_train_state(params: GaussianParams, optims: GroupOptimizers,
                     num_cameras: int, use_bilateral_grid: bool = False,
                     bilateral_grid_shape=(16, 16, 8)) -> TrainState:
    """Zero moments, zero camera deltas and zero stats on the params'
    device; with ``use_bilateral_grid``, identity grids (one per camera)
    with zero moments."""
    dev = params.means.device
    cam = torch.zeros((max(num_cameras, 1), 6), dtype=torch.float32,
                      device=dev)
    grids = gstate = None
    if use_bilateral_grid:
        grids = init_bilateral_grids(max(num_cameras, 1),
                                     tuple(bilateral_grid_shape), dev)
        gstate = adam_init(grids)
    return TrainState(
        params=params,
        opt_state=optims.init(params.trainable_dict()),
        camera_opt=cam,
        camera_opt_state=adam_init(cam),
        stats=DensifyStats.zeros(params.capacity, dev),
        step=0,
        bilateral_grids=grids,
        bilateral_grid_state=gstate,
    )


def from_jax_train_state(d: Dict, device="cuda",
                         mesh=None) -> TrainState:
    """A :class:`TrainState` from plain numpy dicts of a JAX ``TrainState``
    (with a ``parallel.mesh.Mesh``, this rank's rows of it, on the mesh's
    device: a JAX sharded step's global arrays carried to each rank):

    ``{"params": {field: array}, "opt_state": {group: {"count", "mu",
    "nu"}}, "camera_opt": array, "camera_opt_state": {"count", "mu", "nu"},
    "stats": {"grad_norm_sum", "vis_count", "max_radii_frac"}, "step": int}``
    and, when the grid is on, ``"bilateral_grids"`` and
    ``"bilateral_grid_state"`` ({"count", "mu", "nu"}) (the Adam count of a
    group is its ``ScaleByAdamState.count``)."""
    dev = mesh.device if mesh is not None else resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), device=dev)

    def adam(s):
        return {"count": t(np.asarray(s["count"], np.int32)),
                "mu": t(s["mu"]), "nu": t(s["nu"])}

    state = TrainState(
        params=GaussianParams(**{f: t(d["params"][f]) for f in FIELDS}),
        opt_state={g: adam(d["opt_state"][g]) for g in GROUPS},
        camera_opt=t(d["camera_opt"]),
        camera_opt_state=adam(d["camera_opt_state"]),
        stats=DensifyStats(**{k: t(v) for k, v in d["stats"].items()}),
        step=int(d["step"]),
        bilateral_grids=(t(d["bilateral_grids"])
                         if d.get("bilateral_grids") is not None else None),
        bilateral_grid_state=(adam(d["bilateral_grid_state"])
                              if d.get("bilateral_grid_state") is not None
                              else None),
    )
    if mesh is None:
        return state
    from qed_splatter_tpu_torch.parallel.dp import shard_state

    return shard_state(state, mesh)


@dataclasses.dataclass
class StepGrads:
    """One step's loss and gradients, before hygiene and the optimizer."""

    loss: torch.Tensor
    losses: Dict[str, torch.Tensor]
    out: object                    # RenderOutputs
    params: Dict[str, torch.Tensor]  # group -> gradient
    camera_opt: torch.Tensor       # [num_cameras, 6]
    absgrad: Optional[torch.Tensor]  # [C, 2] per-gaussian |grad| sums
    bilateral_grids: Optional[torch.Tensor] = None  # [num_cameras, ...]
    bilagrid_clamped: Optional[torch.Tensor] = None  # 0-d, with the grid


@dataclasses.dataclass
class StepInputs:
    """One step's inputs, every one a tensor on the step's device."""

    c2w: torch.Tensor              # [3or4, 4]
    K: torch.Tensor                # [3, 3]
    cam_idx: torch.Tensor          # [1] integer: the row of camera_opt
    rgb: torch.Tensor              # [H, W, 3] float in [0, 1]
    depth: Optional[torch.Tensor]  # [H, W, 1] (has_depth)
    mask: Optional[torch.Tensor]   # [H, W, 1] (has_mask)
    background: torch.Tensor       # [3] this step's background colour
    step: torch.Tensor             # 0-d int32 step counter, +1 per run


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


class TrainStep:
    """The step for one (width, height) bucket; see :func:`make_train_step`.

    :meth:`run` is the step's body, and it is capture-clean: it reads every
    input from :class:`StepInputs` tensors, writes every result in place
    (parameters, moments, Adam counts, statistics, the step counter), makes
    no host sync and builds no tensor from a host value. So one replay of a
    CUDA graph captured around it equals one eager call
    (``engine/scan_runner.py``). ``__call__`` is the per-step form: the
    host batch moved to the device and a background drawn, then :meth:`run`.
    """

    def __init__(self, cfg: ModelConfig, optims: GroupOptimizers, width: int,
                 height: int, has_depth: bool, has_mask: bool = False,
                 camera_opt_on: Optional[bool] = None,
                 need_absgrad: bool = True, device="cuda"):
        self.cfg, self.optims = cfg, optims
        self.width, self.height = width, height
        self.has_depth, self.has_mask = has_depth, has_mask
        self.camera_opt_on = (cfg.camera_opt_mode != "off"
                              if camera_opt_on is None else camera_opt_on)
        self.need_absgrad = need_absgrad
        self.device = resolve_device(device)
        ts = cfg.tile_size
        self.num_tiles = (-(-width // ts)) * (-(-height // ts))
        self.max_hw = max(width, height)
        # held here: a CUDA graph of the step reads them and keeps no input
        # alive, and SSIM's own cache may drop them
        self.ssim_bands = ssim_bands(width, height, device=self.device)

    def inputs(self, batch: Dict, generator: Optional[torch.Generator],
               step: int) -> StepInputs:
        """A host (or device) batch as :class:`StepInputs` on the device,
        with the background drawn from ``generator``."""
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return StepInputs(
            c2w=t(batch["c2w"]), K=t(batch["K"]),
            cam_idx=torch.full((1,), int(batch["cam_idx"]),
                               dtype=torch.int64, device=dev),
            rgb=t(batch["rgb"]),
            depth=t(batch["depth"]) if self.has_depth else None,
            mask=t(batch["mask"]) if self.has_mask else None,
            background=background_color(self.cfg, dev, train=True,
                                        generator=generator),
            step=torch.full((), int(step), dtype=torch.int32, device=dev))

    def grads(self, state: TrainState, batch: Dict,
              generator: Optional[torch.Generator]) -> StepGrads:
        """Loss and raw gradients of one step; touches no state."""
        return self._grads(state, self.inputs(batch, generator, state.step))

    @tracing.step_body
    def _grads(self, state: TrainState, inp: StepInputs) -> StepGrads:
        cfg = self.cfg
        tracing.stage("render.project")
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.trainable_dict().items()}
        cam = state.camera_opt.detach().requires_grad_(True)
        grids = (state.bilateral_grids.detach().requires_grad_(True)
                 if cfg.use_bilateral_grid else None)
        side = None
        if self.need_absgrad:
            # the kernel path takes the absgrad seed on the gather, the
            # plain path the per-slot tile_eps
            shape = ((state.params.capacity, 2) if cfg.use_pallas
                     else (self.num_tiles, cfg.max_per_tile, 2))
            side = torch.zeros(shape, dtype=torch.float32, device=self.device,
                               requires_grad=True)
        p = state.params.replace_trainable(leaves)
        c2w = inp.c2w
        if self.camera_opt_on:
            # by a device index: a host index would be frozen into a graph
            delta = cam.index_select(0, inp.cam_idx.reshape(1))[0]
            c2w = apply_camera_opt(c2w, delta)
        out = render(
            p, c2w, inp.K, self.width, self.height, cfg, step=inp.step,
            train=True, device=self.device, background=inp.background,
            tile_eps=None if cfg.use_pallas else side,
            absgrad_seed=side if cfg.use_pallas else None,
        )
        clamped = None
        if grids is not None:
            # the camera's colour correction, on the training render only
            tracing.stage("render.bilagrid")
            grid = grids.index_select(0, inp.cam_idx.reshape(1))[0]
            rgb = apply_bilateral_grid(grid, out.rgb)
            # the share of channel values the clamp cuts (their gradient is
            # zero): how much of the image the grid has saturated
            clamped = ((rgb < 0.0) | (rgb > 1.0)).to(torch.float32).mean()
            rgb, = tracing.stage_outputs("render.bilagrid",
                                         torch.clamp(rgb, 0.0, 1.0))
            out = dataclasses.replace(out, rgb=rgb)
        loss, losses = total_loss(out, inp.rgb, inp.depth, p, cfg, inp.step,
                                  inp.mask, self.ssim_bands)
        if self.camera_opt_on:
            reg = camera_opt_regularizer(delta)
            losses = dict(losses, camera_opt_regularizer=reg)
            loss = loss + reg
        if grids is not None:
            tv = 10.0 * total_variation_loss(grids)
            losses = dict(losses, tv_loss=tv)
            loss = loss + tv
        loss, = tracing.stage_outputs("loss.other", loss)
        inputs = ([*leaves.values(), cam]
                  + ([grids] if grids is not None else [])
                  + ([side] if side is not None else []))
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        g_params = {k: _zeros_if_none(g, leaves[k])
                    for k, g in zip(leaves, grads)}
        g_cam = _zeros_if_none(grads[len(leaves)], cam)
        g_grids = (_zeros_if_none(grads[len(leaves) + 1], grids)
                   if grids is not None else None)
        absgrad = None
        if side is not None:
            g_side = _zeros_if_none(grads[-1], side)
            absgrad = (g_side if cfg.use_pallas else absgrad_scatter(
                g_side, out.tile_lists, state.params.capacity))
        return StepGrads(loss.detach(), {k: v.detach() for k, v in
                                         losses.items()},
                         out, g_params, g_cam, absgrad, g_grids, clamped)

    @tracing.step_body
    def run(self, state: TrainState, inp: StepInputs) -> Dict:
        """The step's body: updates ``state``'s tensors and ``inp.step`` in
        place and returns the metrics (0-d device tensors)."""
        cfg = self.cfg
        sg = self._grads(state, inp)
        g_params, g_cam, g_grids = sg.params, sg.camera_opt, \
            sg.bilateral_grids
        tracing.stage("step.stats")
        if sg.absgrad is not None:
            accumulate_stats_(state.stats, sg.absgrad, sg.out.radii,
                              self.max_hw)

        with torch.no_grad():
            tracing.stage("step.optimizer")
            # gradient hygiene before any optimizer state is touched
            nonfinite = None
            if cfg.sanitize_grads:
                every = [*g_params.values(), g_cam] + (
                    [g_grids] if g_grids is not None else [])
                nonfinite = sum((~torch.isfinite(g)).sum().to(torch.float32)
                                for g in every)
                for g in every:
                    torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
            if cfg.grad_clip_norm > 0.0:
                def clip(g):
                    n = torch.sqrt(torch.sum(g * g) + 1e-20)
                    return g * torch.clamp(cfg.grad_clip_norm / n, max=1.0)

                g_params = {k: clip(g) for k, g in g_params.items()}
                g_cam = clip(g_cam)

            self.optims.update(g_params, state.opt_state,
                               state.params.trainable_dict())
            if self.camera_opt_on:
                self.optims.update_group("camera_opt", state.camera_opt,
                                         g_cam, state.camera_opt_state)
            if g_grids is not None:
                self.optims.update_group("bilateral_grid",
                                         state.bilateral_grids, g_grids,
                                         state.bilateral_grid_state)

            tracing.stage("step.metrics")
            out = sg.out
            metrics = dict(sg.losses)
            metrics["loss"] = sg.loss
            if cfg.sanitize_grads:
                metrics["nonfinite_grads"] = nonfinite
            metrics["gaussian_count"] = state.params.num_alive()
            metrics["psnr"] = -10.0 * torch.log10(
                torch.mean((out.rgb.detach() - inp.rgb) ** 2) + 1e-12)
            metrics["tile_overflow"] = out.tile_overflow
            metrics["bbox_truncated"] = out.bbox_truncated
            metrics["tile_max_count"] = out.tile_max_count
            if sg.bilagrid_clamped is not None:
                metrics["bilagrid_clamped"] = sg.bilagrid_clamped
            inp.step.add_(1)
        return metrics

    @tracing.step_body
    def __call__(self, state: TrainState, batch: Dict,
                 generator: Optional[torch.Generator]):
        metrics = self.run(state, self.inputs(batch, generator, state.step))
        tracing.stage("step.end")
        return dataclasses.replace(state, step=state.step + 1), metrics


def make_train_step(cfg: ModelConfig, optims: GroupOptimizers, width: int,
                    height: int, has_depth: bool, has_mask: bool = False,
                    camera_opt_on: Optional[bool] = None,
                    need_absgrad: bool = True, device="cuda") -> TrainStep:
    """The step for one (width, height) bucket:
    ``step(state, batch, generator) -> (state, metrics)``.

    ``batch``: ``c2w`` [3or4, 4], ``K`` [3, 3], ``cam_idx`` int, ``rgb``
    [H, W, 3], ``depth`` [H, W, 1] (if ``has_depth``), ``mask`` [H, W, 1]
    (if ``has_mask``), numpy or tensors. ``generator`` (a
    ``torch.Generator`` on ``device``) draws the random background; it may
    be None for a black or white background. ``need_absgrad=False`` drops
    the absgrad side channel (lawful once densification has stopped).
    ``step.grads(state, batch, generator)`` returns the loss and raw
    gradients of a step without updating anything."""
    return TrainStep(cfg, optims, width, height, has_depth, has_mask,
                     camera_opt_on, need_absgrad, device)
