"""The sharded multi-camera train step: view parallelism x gaussian
sharding over :class:`~qed_splatter_tpu_torch.parallel.mesh.Mesh` ranks
(port of ``parallel/dp.py``).

Each rank holds its **local** rows of the gaussian state (parameters, Adam
moments, densification statistics: capacity / ``num_model`` contiguous
rows) and renders its **local** cameras (``B / num_data``) with the port's
single-camera path: ``render`` (the CUDA kernels on CUDA tensors),
``total_loss``, camera opt and the bilateral grid. The collectives sit
where ``jax.shard_map`` put them in the JAX step, written by hand:

- the trainable rows and ``alive`` are all-gathered over ``model`` before
  rendering; the gradient of the full rows is reduce-scattered over
  ``model`` (sum), all-reduced over ``data`` and divided by ``num_model``
  (every model peer rendered the same cameras, so the sum counts each of
  them ``num_model`` times). Camera-opt and grid gradients are all-reduced
  over ``data`` only. The loss is the sum over the rank's cameras / ``B``,
  all-reduced over ``data``; the grids' TV term enters once a step, as
  ``tv * b_local / B`` on each data slice;
- absgrad: on the kernel path one ``[capacity, 2]`` zero seed is shared by
  the rank's cameras, so its gradient sums over them; on the plain path
  each camera's ``tile_eps`` is scattered and the scatters summed. The sum
  is all-reduced over ``data`` and sliced to the local rows; the
  statistics take the norm of that camera-summed absgrad, the visibility
  count summed and the radius fraction maxed over cameras and ``data``;
- hygiene: the non-finite count is summed over ``model`` for the gaussian
  leaves, plus the camera-opt and grid counts; the clip of a gaussian leaf
  takes its squared norm summed over ``model``, the camera-opt clip is
  local;
- Adam runs on the local rows only: moments never exist unsharded.

Where the JAX step ran one collective a leaf, this one packs the leaves of
a collective into one buffer (one all-gather of the rows, one
reduce-scatter of their gradients, one all-reduce sum and one max over
``data``, one sum over ``model`` of the scalars): the same sums, fewer
round trips. The metrics are ``dp.py``'s: each loss term averaged over
``B``, ``tile_overflow`` summed over ``B`` and divided by ``B``,
``tile_max_count`` maxed over ``data``, ``gaussian_count`` summed over
``model``, ``psnr`` from the mean MSE. There is no ``bbox_truncated``, as
in the JAX step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.engine.densify import DensifyStats
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import TrainState
from qed_splatter_tpu_torch.models.bilateral_grid import (
    apply_bilateral_grid,
    total_variation_loss,
)
from qed_splatter_tpu_torch.models.camera_opt import (
    apply_camera_opt,
    camera_opt_regularizer,
)
from qed_splatter_tpu_torch.models.gaussians import FIELDS, GROUPS, \
    GaussianParams
from qed_splatter_tpu_torch.models.splatfacto import (
    background_color,
    render,
    total_loss,
)
from qed_splatter_tpu_torch.ops.rasterize import absgrad_scatter
from qed_splatter_tpu_torch.ops.ssim import ssim_bands
from qed_splatter_tpu_torch.parallel.mesh import Mesh

STATS = tuple(f.name for f in dataclasses.fields(DensifyStats))


# ------------------------------------------------------------ row shards

def _pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """[rows, sum of widths] float32 from tensors of one row count."""
    return torch.cat([t.reshape(t.shape[0], -1).to(torch.float32)
                      for t in tensors], dim=1)


def _unpack(buf: torch.Tensor, likes: List[torch.Tensor]) -> List:
    out, at = [], 0
    for t in likes:
        w = int(np.prod(t.shape[1:], dtype=np.int64))
        part = buf[:, at:at + w].reshape(buf.shape[0], *t.shape[1:])
        out.append(part > 0.5 if t.dtype == torch.bool else
                   part.to(t.dtype).contiguous())
        at += w
    return out


def _row_leaves(state: TrainState) -> List[torch.Tensor]:
    """The capacity-row leaves, in one order: the params, each group's
    moments, the statistics."""
    p = state.params
    return ([getattr(p, f) for f in FIELDS]
            + [state.opt_state[g][m] for g in GROUPS for m in ("mu", "nu")]
            + [getattr(state.stats, f) for f in STATS])


def _with_rows(state: TrainState, rows: List[torch.Tensor]) -> TrainState:
    nf, ng = len(FIELDS), len(GROUPS)
    params = GaussianParams(**dict(zip(FIELDS, rows[:nf])))
    moments = rows[nf:nf + 2 * ng]
    opt = {g: dict(state.opt_state[g], mu=moments[2 * i],
                   nu=moments[2 * i + 1]) for i, g in enumerate(GROUPS)}
    stats = DensifyStats(**dict(zip(STATS, rows[nf + 2 * ng:])))
    return dataclasses.replace(state, params=params, opt_state=opt,
                               stats=stats)


def local_rows(capacity: int, mesh: Mesh) -> slice:
    """The rows of the capacity a rank holds; raises unless ``num_model``
    divides the capacity."""
    if capacity % mesh.num_model:
        raise ValueError(f"capacity {capacity} is not divisible by "
                         f"num_model_shards {mesh.num_model}")
    n = capacity // mesh.num_model
    return slice(mesh.model_index * n, (mesh.model_index + 1) * n)


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The rank's local rows of a full state (new tensors; the replicated
    leaves are kept). Every leaf with the capacity's leading dim is split
    into ``num_model`` contiguous blocks."""
    rows = local_rows(state.params.capacity, mesh)
    return _with_rows(state, [t[rows].clone() for t in _row_leaves(state)])


def gather_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The full state from every rank's local rows (an all-gather over
    ``model``; every model peer gets it)."""
    if mesh.num_model == 1:
        return state
    leaves = _row_leaves(state)
    return _with_rows(state, _unpack(mesh.all_gather_rows(_pack(leaves)),
                                     leaves))


# ------------------------------------------------------------ the step

class ShardedTrainStep:
    """The B-camera step of one (width, height) bucket on one rank; see
    :func:`make_sharded_train_step`."""

    def __init__(self, cfg: ModelConfig, optims: GroupOptimizers, width: int,
                 height: int, mesh: Mesh, has_depth: bool,
                 has_mask: bool = False,
                 camera_opt_on: Optional[bool] = None,
                 need_absgrad: bool = True):
        self.cfg, self.optims, self.mesh = cfg, optims, mesh
        self.width, self.height = width, height
        self.has_depth, self.has_mask = has_depth, has_mask
        self.camera_opt_on = (cfg.camera_opt_mode != "off"
                              if camera_opt_on is None else camera_opt_on)
        self.need_absgrad = need_absgrad
        self.device = mesh.device
        ts = cfg.tile_size
        self.num_tiles = (-(-width // ts)) * (-(-height // ts))
        self.max_hw = max(width, height)
        self.ssim_bands = ssim_bands(width, height, device=self.device)

    def backgrounds(self, b_total: int,
                    generator: Optional[torch.Generator],
                    every: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[b_local, 3]: this data slice's part of one stream of ``B``
        backgrounds (``every``, or drawn from ``generator``), so the draw
        does not depend on the mesh."""
        dev = self.device
        if every is None:
            every = torch.stack([background_color(self.cfg, dev, True,
                                                  generator)
                                 for _ in range(b_total)])
        every = torch.as_tensor(every, dtype=torch.float32, device=dev)
        b_local = b_total // self.mesh.num_data
        lo = self.mesh.data_index * b_local
        return every[lo:lo + b_local]

    def _batch(self, batch: Dict) -> Dict:
        dev = self.device
        out = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
               for k in ("c2w", "K", "rgb")}
        idx = batch["cam_idx"]
        out["cam_idx"] = (idx if isinstance(idx, torch.Tensor) else
                          torch.as_tensor(np.asarray(idx))).to(
                              device=dev, dtype=torch.int64)
        for k, on in (("depth", self.has_depth), ("mask", self.has_mask)):
            out[k] = (torch.as_tensor(batch[k], dtype=torch.float32,
                                      device=dev) if on else None)
        return out

    def __call__(self, state: TrainState, batch: Dict,
                 generator: Optional[torch.Generator],
                 backgrounds: Optional[torch.Tensor] = None):
        """One step on the rank's local rows and cameras: updates the
        state's tensors in place; returns ``(state, metrics)`` with the step
        counter advanced. ``batch`` holds the rank's ``b_local`` cameras
        (``c2w`` [b, 3or4, 4], ``K`` [b, 3, 3], ``cam_idx`` [b], ``rgb``
        [b, H, W, 3], ``depth`` / ``mask`` [b, H, W, 1]); ``generator``
        draws the ``B`` random backgrounds (None for a fixed colour), or
        ``backgrounds`` ([B, 3]) gives them."""
        cfg, mesh, dev = self.cfg, self.mesh, self.device
        b = self._batch(batch)
        b_local = b["rgb"].shape[0]
        b_total = b_local * mesh.num_data
        cap_local = state.params.capacity
        cap = cap_local * mesh.num_model
        rows = local_rows(cap, mesh)
        bgs = self.backgrounds(b_total, generator, backgrounds)
        step_t = torch.full((), int(state.step), dtype=torch.int32,
                            device=dev)

        # the full rows: one all-gather over 'model'
        local = state.params.trainable_dict()
        likes = [*local.values(), state.params.alive]
        full = (_unpack(mesh.all_gather_rows(_pack(likes)), likes)
                if mesh.num_model > 1 else likes)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in zip(local, full[:len(local)])}
        p = state.params.replace_trainable(leaves).replace(alive=full[-1])
        cam = state.camera_opt.detach().requires_grad_(True)
        grids = (state.bilateral_grids.detach().requires_grad_(True)
                 if cfg.use_bilateral_grid else None)
        sides: List[torch.Tensor] = []
        if self.need_absgrad:
            # one seed for every local camera on the kernel path; one
            # tile_eps a camera on the plain path
            shapes = ([(cap, 2)] if cfg.use_pallas else
                      [(self.num_tiles, cfg.max_per_tile, 2)] * b_local)
            sides = [torch.zeros(s, dtype=torch.float32, device=dev,
                                 requires_grad=True) for s in shapes]

        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        terms: Dict[str, torch.Tensor] = {}
        radii, tile_lists, mse, overflow, tmc = [], [], [], [], []
        for i in range(b_local):
            c2w = b["c2w"][i]
            idx = b["cam_idx"][i:i + 1]
            if self.camera_opt_on:
                delta = cam.index_select(0, idx)[0]
                c2w = apply_camera_opt(c2w, delta)
            side = (sides[0] if cfg.use_pallas else sides[i]) if sides \
                else None
            out = render(p, c2w, b["K"][i], self.width, self.height, cfg,
                         step=step_t, train=True, device=dev,
                         background=bgs[i],
                         tile_eps=None if cfg.use_pallas else side,
                         absgrad_seed=side if cfg.use_pallas else None)
            if grids is not None:
                grid = grids.index_select(0, idx)[0]
                out = dataclasses.replace(out, rgb=torch.clamp(
                    apply_bilateral_grid(grid, out.rgb), 0.0, 1.0))
            depth = b["depth"][i] if self.has_depth else None
            mask = b["mask"][i] if self.has_mask else None
            loss, losses = total_loss(out, b["rgb"][i], depth, p, cfg,
                                      step_t, mask, self.ssim_bands)
            if self.camera_opt_on:
                reg = camera_opt_regularizer(delta)
                losses = dict(losses, camera_opt_regularizer=reg)
                loss = loss + reg
            loss_sum = loss_sum + loss
            for k, v in losses.items():
                terms[k] = terms.get(k, 0.0) + v.detach()
            radii.append(out.radii)
            tile_lists.append(out.tile_lists)
            mse.append(torch.mean((out.rgb.detach() - b["rgb"][i]) ** 2))
            overflow.append(out.tile_overflow.to(torch.float32))
            tmc.append(out.tile_max_count.to(torch.float32))
        if grids is not None:
            tv = 10.0 * total_variation_loss(grids)
            terms["tv_loss"] = tv.detach() * b_local
            # the TV term enters once a step, not once a camera
            loss_sum = loss_sum + tv * b_local / b_total
        loss_local = loss_sum / b_total

        inputs = ([*leaves.values(), cam] + ([grids] if grids is not None
                                             else []) + sides)
        grads = torch.autograd.grad(loss_local, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        n = len(leaves)
        g_full, g_cam = grads[:n], grads[n]
        g_grid = grads[n + 1] if grids is not None else None
        g_sides = grads[n + 1 + (grids is not None):]

        with torch.no_grad():
            # 'model': the full-row gradients reduce-scattered (sum)
            if mesh.num_model > 1:
                g_loc = _unpack(mesh.reduce_scatter_rows(_pack(g_full)),
                                list(local.values()))
            else:
                g_loc = g_full
            vis_b = torch.stack([r > 0 for r in radii])     # [b_local, cap]
            absg = None
            if self.need_absgrad:
                if cfg.use_pallas:
                    absg = g_sides[0]
                else:
                    absg = sum(absgrad_scatter(g, tl, cap)
                               for g, tl in zip(g_sides, tile_lists))
                absg = absg[rows]
            vis = vis_b.to(torch.float32).sum(0)[rows]
            # times the reciprocal: XLA compiles the JAX step's
            # ``/ max_hw`` so, and the fraction is held bit for bit
            frac = torch.where(vis_b, torch.stack(radii).to(
                torch.float32) * (1.0 / self.max_hw), 0.0).amax(0)[rows]

            # 'data': one sum (gradients, absgrad, visibility, loss terms)
            # and one max (radius fraction, tile_max_count)
            names = sorted(terms)
            scal = torch.stack([loss_local.detach(), *[terms[k] for k in
                                                       names],
                                torch.stack(overflow).sum(),
                                torch.stack(mse).sum()])
            parts = ([*g_loc, g_cam] + ([g_grid] if g_grid is not None
                                        else [])
                     + ([absg] if absg is not None else [])
                     + [vis, scal])
            flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in parts]),
                                   "data")
            parts = _split_like(flat, parts)
            g_loc = [g / mesh.num_model for g in parts[:n]]
            g_cam = parts[n]
            at = n + 1
            if g_grid is not None:
                g_grid, at = parts[at], at + 1
            if absg is not None:
                absg, at = parts[at], at + 1
            vis, scal = parts[at], parts[at + 1]
            mx = mesh.all_reduce(torch.cat([frac, torch.stack(tmc).amax(
                ).reshape(1)]), "data", op="max")
            frac, tile_max = mx[:-1], mx[-1]

            # hygiene and clip: sums over 'model' of the local gaussian
            # leaves' counts and squared norms (after the clean)
            nonfinite_local = sum((~torch.isfinite(g)).sum().to(
                torch.float32) for g in g_loc)
            nonfinite_rep = (~torch.isfinite(g_cam)).sum().to(torch.float32)
            if g_grid is not None:
                nonfinite_rep = nonfinite_rep + (~torch.isfinite(
                    g_grid)).sum().to(torch.float32)
            if cfg.sanitize_grads:
                for g in [*g_loc, g_cam] + ([g_grid] if g_grid is not None
                                            else []):
                    torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
            sq = torch.stack([torch.sum(g * g) for g in g_loc])
            red = mesh.all_reduce(torch.cat([
                nonfinite_local.reshape(1), sq,
                state.params.num_alive().to(torch.float32).reshape(1)]),
                "model")
            nonfinite = red[0] + nonfinite_rep
            if cfg.grad_clip_norm > 0.0:
                norms = torch.sqrt(red[1:1 + n] + 1e-20)
                g_loc = [g * torch.clamp(cfg.grad_clip_norm / nrm, max=1.0)
                         for g, nrm in zip(g_loc, norms)]
                ncam = torch.sqrt(torch.sum(g_cam * g_cam) + 1e-20)
                g_cam = g_cam * torch.clamp(cfg.grad_clip_norm / ncam,
                                            max=1.0)

            if absg is not None:
                st = state.stats
                gnorm = torch.linalg.vector_norm(absg, dim=-1)
                st.grad_norm_sum.add_(torch.where(vis > 0, gnorm, 0.0))
                st.vis_count.add_(vis)
                torch.maximum(st.max_radii_frac, frac,
                              out=st.max_radii_frac)

            # Adam on the local rows
            self.optims.update(dict(zip(local, g_loc)), state.opt_state,
                               local)
            if self.camera_opt_on:
                self.optims.update_group("camera_opt", state.camera_opt,
                                         g_cam, state.camera_opt_state)
            if g_grid is not None:
                self.optims.update_group("bilateral_grid",
                                         state.bilateral_grids, g_grid,
                                         state.bilateral_grid_state)

            metrics = {k: scal[1 + i] / b_total for i, k in enumerate(names)}
            metrics["loss"] = scal[0]
            if cfg.sanitize_grads:
                metrics["nonfinite_grads"] = nonfinite
            metrics["tile_overflow"] = scal[-2] / b_total
            metrics["tile_max_count"] = tile_max
            metrics["gaussian_count"] = red[-1]
            metrics["psnr"] = -10.0 * torch.log10(scal[-1] / b_total + 1e-12)
        return dataclasses.replace(state, step=state.step + 1), metrics


def _split_like(flat: torch.Tensor, likes: List[torch.Tensor]) -> List:
    out, at = [], 0
    for t in likes:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def make_sharded_train_step(cfg: ModelConfig, optims: GroupOptimizers,
                            width: int, height: int, mesh: Mesh,
                            has_depth: bool, has_mask: bool = False,
                            camera_opt_on: Optional[bool] = None,
                            need_absgrad: bool = True) -> ShardedTrainStep:
    """The rank's step: ``step(state, batch, generator) -> (state,
    metrics)`` on its local rows (``shard_state``) and its ``B / num_data``
    cameras of the step's ``B``. Every rank of the mesh calls it once a
    step, on the same step of the same camera stream."""
    return ShardedTrainStep(cfg, optims, width, height, mesh, has_depth,
                            has_mask, camera_opt_on, need_absgrad)
