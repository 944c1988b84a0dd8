"""The training step: render -> loss -> backward -> Adam -> stats (port of
``engine/train_step.py``).

One call does, for one camera, in the JAX step's order:

- the training render with the camera-opt delta applied, and
  :func:`~qed_splatter_tpu_torch.models.splatfacto.total_loss` plus the
  camera-opt regularizer;
- gradients to the six gaussian groups, the camera deltas and the absgrad
  side channel (the compositing backward kernel on CUDA tensors);
- the count and zeroing of non-finite gradient elements, then the optional
  global-norm clip, before any optimizer state is touched;
- the per-group Adam, then the camera Adam;
- the densification statistics.

Parameters and Adam moments are updated **in place**: the returned
:class:`TrainState` holds the same parameter and moment tensors as the one
passed in, with new statistics and step. ``cfg.mixed_precision`` takes the
bf16 operand compositing kernels. The bilateral grid is not ported and
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from qed_splatter_tpu_torch import not_ported, resolve_device
from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.engine.densify import DensifyStats, \
    accumulate_stats
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers, adam_init
from qed_splatter_tpu_torch.models.camera_opt import (
    apply_camera_opt,
    camera_opt_regularizer,
)
from qed_splatter_tpu_torch.models.gaussians import (
    FIELDS,
    GROUPS,
    GaussianParams,
)
from qed_splatter_tpu_torch.models.splatfacto import render, total_loss
from qed_splatter_tpu_torch.ops.rasterize import absgrad_scatter


def refuse_bilateral_grid() -> NotImplementedError:
    return not_ported("use_bilateral_grid=True", 6, "models/bilateral_grid.py")


@dataclasses.dataclass
class TrainState:
    """Everything the step updates."""

    params: GaussianParams
    opt_state: Dict                # group -> {"count", "mu", "nu"}
    camera_opt: torch.Tensor       # [num_cameras, 6] SO3xR3 deltas
    camera_opt_state: Dict         # {"count", "mu", "nu"} of camera_opt
    stats: DensifyStats
    step: int


def init_train_state(params: GaussianParams, optims: GroupOptimizers,
                     num_cameras: int,
                     use_bilateral_grid: bool = False) -> TrainState:
    """Zero moments, zero camera deltas and zero stats on the params'
    device."""
    if use_bilateral_grid:
        raise refuse_bilateral_grid()
    dev = params.means.device
    cam = torch.zeros((max(num_cameras, 1), 6), dtype=torch.float32,
                      device=dev)
    return TrainState(
        params=params,
        opt_state=optims.init(params.trainable_dict()),
        camera_opt=cam,
        camera_opt_state=adam_init(cam),
        stats=DensifyStats.zeros(params.capacity, dev),
        step=0,
    )


def from_jax_train_state(d: Dict, device="cuda") -> TrainState:
    """A :class:`TrainState` from plain numpy dicts of a JAX ``TrainState``:

    ``{"params": {field: array}, "opt_state": {group: {"count", "mu",
    "nu"}}, "camera_opt": array, "camera_opt_state": {"count", "mu", "nu"},
    "stats": {"grad_norm_sum", "vis_count", "max_radii_frac"}, "step": int}``
    (the Adam count of a group is its ``ScaleByAdamState.count``)."""
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), device=dev)

    def adam(s):
        return {"count": t(np.asarray(s["count"], np.int32)),
                "mu": t(s["mu"]), "nu": t(s["nu"])}

    return TrainState(
        params=GaussianParams(**{f: t(d["params"][f]) for f in FIELDS}),
        opt_state={g: adam(d["opt_state"][g]) for g in GROUPS},
        camera_opt=t(d["camera_opt"]),
        camera_opt_state=adam(d["camera_opt_state"]),
        stats=DensifyStats(**{k: t(v) for k, v in d["stats"].items()}),
        step=int(d["step"]),
    )


@dataclasses.dataclass
class StepGrads:
    """One step's loss and gradients, before hygiene and the optimizer."""

    loss: torch.Tensor
    losses: Dict[str, torch.Tensor]
    out: object                    # RenderOutputs
    params: Dict[str, torch.Tensor]  # group -> gradient
    camera_opt: torch.Tensor       # [num_cameras, 6]
    absgrad: Optional[torch.Tensor]  # [C, 2] per-gaussian |grad| sums


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


class TrainStep:
    """The step for one (width, height) bucket; see :func:`make_train_step`."""

    def __init__(self, cfg: ModelConfig, optims: GroupOptimizers, width: int,
                 height: int, has_depth: bool, has_mask: bool = False,
                 camera_opt_on: Optional[bool] = None,
                 need_absgrad: bool = True, device="cuda"):
        if cfg.use_bilateral_grid:
            raise refuse_bilateral_grid()
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

    def _batch(self, batch: Dict):
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return (t(batch["c2w"]), t(batch["K"]), int(batch["cam_idx"]),
                t(batch["rgb"]),
                t(batch["depth"]) if self.has_depth else None,
                t(batch["mask"]) if self.has_mask else None)

    def grads(self, state: TrainState, batch: Dict,
              generator: Optional[torch.Generator]) -> StepGrads:
        """Loss and raw gradients of one step; touches no state."""
        cfg = self.cfg
        c2w, K, cam_idx, gt_rgb, gt_depth, mask = self._batch(batch)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.trainable_dict().items()}
        cam = state.camera_opt.detach().requires_grad_(True)
        side = None
        if self.need_absgrad:
            # the kernel path takes the absgrad seed on the gather, the
            # plain path the per-slot tile_eps
            shape = ((state.params.capacity, 2) if cfg.use_pallas
                     else (self.num_tiles, cfg.max_per_tile, 2))
            side = torch.zeros(shape, dtype=torch.float32, device=self.device,
                               requires_grad=True)
        p = state.params.replace_trainable(leaves)
        if self.camera_opt_on:
            c2w = apply_camera_opt(c2w, cam[cam_idx])
        out = render(
            p, c2w, K, self.width, self.height, cfg, step=state.step,
            train=True, device=self.device, generator=generator,
            tile_eps=None if cfg.use_pallas else side,
            absgrad_seed=side if cfg.use_pallas else None,
        )
        loss, losses = total_loss(out, gt_rgb, gt_depth, p, cfg, state.step,
                                  mask)
        if self.camera_opt_on:
            reg = camera_opt_regularizer(cam[cam_idx])
            losses = dict(losses, camera_opt_regularizer=reg)
            loss = loss + reg
        inputs = [*leaves.values(), cam] + ([side] if side is not None else [])
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        g_params = {k: _zeros_if_none(g, leaves[k])
                    for k, g in zip(leaves, grads)}
        g_cam = _zeros_if_none(grads[len(leaves)], cam)
        absgrad = None
        if side is not None:
            g_side = _zeros_if_none(grads[-1], side)
            absgrad = (g_side if cfg.use_pallas else absgrad_scatter(
                g_side, out.tile_lists, state.params.capacity))
        return StepGrads(loss.detach(), {k: v.detach() for k, v in
                                         losses.items()},
                         out, g_params, g_cam, absgrad)

    def __call__(self, state: TrainState, batch: Dict,
                 generator: Optional[torch.Generator]):
        cfg = self.cfg
        sg = self.grads(state, batch, generator)
        g_params, g_cam = sg.params, sg.camera_opt
        stats = state.stats
        if sg.absgrad is not None:
            stats = accumulate_stats(stats, sg.absgrad, sg.out.radii,
                                     self.max_hw)

        with torch.no_grad():
            # gradient hygiene before any optimizer state is touched
            nonfinite = None
            if cfg.sanitize_grads:
                every = [*g_params.values(), g_cam]
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

            out = sg.out
            gt_rgb = torch.as_tensor(batch["rgb"], dtype=torch.float32,
                                     device=self.device)
            metrics = dict(sg.losses)
            metrics["loss"] = sg.loss
            if cfg.sanitize_grads:
                metrics["nonfinite_grads"] = nonfinite
            metrics["gaussian_count"] = state.params.num_alive()
            metrics["psnr"] = -10.0 * torch.log10(
                torch.mean((out.rgb.detach() - gt_rgb) ** 2) + 1e-12)
            metrics["tile_overflow"] = out.tile_overflow
            metrics["bbox_truncated"] = out.bbox_truncated
            metrics["tile_max_count"] = out.tile_max_count

        new_state = dataclasses.replace(state, stats=stats,
                                        step=state.step + 1)
        return new_state, metrics


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
