"""Densification and culling at fixed capacity (port of
``engine/densify.py``).

- :class:`DensifyStats` / :func:`accumulate_stats` (and
  :func:`accumulate_stats_`, in place): per-gaussian
  screen-space gradient statistics accumulated between refines
  (splatfacto's ``xys_grad_norm``, ``vis_counts`` and ``max_2Dsize``).
- :func:`refine`: splatfacto's ``refinement_after`` without dynamic tensor
  growth. Gaussians live in capacity-C buffers with an ``alive`` mask; high
  gradient splats are split (``n_split_samples`` children drawn from the
  parent, scales / 1.6, parent culled) or duplicated, low-opacity and
  (after the first reset window) too-large ones culled. Candidates are
  packed by a cumulative-sum rank and written into free slots by rank;
  when the free-slot budget cannot fund them all, the highest-gradient
  ones win (a stable sort on the same keys as the JAX package, so the same
  ones) and a split parent is never killed without its children. New and
  culled slots get zeroed Adam moments.
- :func:`maybe_reset_opacities`: the opacity reset every
  ``reset_alpha_every * refine_every`` steps.

The step is a Python int here. Split offsets are ``eps`` (``[max_new, 3]``
standard normals) when given, else drawn from ``generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.models.gaussians import GaussianParams
from qed_splatter_tpu_torch.ops.projection import quat_to_rotmat


@dataclasses.dataclass
class DensifyStats:
    grad_norm_sum: torch.Tensor   # [C] sum of absgrad 2-norms
    vis_count: torch.Tensor       # [C] steps visible (radius > 0)
    max_radii_frac: torch.Tensor  # [C] max radius / max(H, W)

    @classmethod
    def zeros(cls, capacity: int, device) -> "DensifyStats":
        return cls(*(torch.zeros((capacity,), dtype=torch.float32,
                                 device=device) for _ in range(3)))


def accumulate_stats(
    stats: DensifyStats,
    absgrad: torch.Tensor,   # [C, 2] summed |d loss / d means2d| this step
    radii: torch.Tensor,     # [C] int32
    max_hw: int,
) -> DensifyStats:
    vis = radii > 0
    g = torch.linalg.vector_norm(absgrad, dim=-1)
    return DensifyStats(
        grad_norm_sum=stats.grad_norm_sum + torch.where(vis, g, 0.0),
        vis_count=stats.vis_count + vis.to(torch.float32),
        max_radii_frac=torch.maximum(
            stats.max_radii_frac,
            torch.where(vis, radii.to(torch.float32) / float(max_hw), 0.0),
        ),
    )


@torch.no_grad()
def accumulate_stats_(stats: DensifyStats, absgrad: torch.Tensor,
                      radii: torch.Tensor, max_hw: int) -> None:
    """:func:`accumulate_stats` written into ``stats``'s own tensors (the
    graph-captured step keeps them at fixed addresses)."""
    new = accumulate_stats(stats, absgrad, radii, max_hw)
    for f in dataclasses.fields(DensifyStats):
        getattr(stats, f.name).copy_(getattr(new, f.name))


class RefineInfo(NamedTuple):
    n_alive: int
    n_culled: int
    n_split: int
    n_dup: int
    n_added: int
    n_dropped: int  # candidates that found no free slot


def _inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))


def _priority(mask: torch.Tensor, avg_grad: torch.Tensor) -> torch.Tensor:
    """[C] rank of each slot in descending ``avg_grad`` among ``mask``
    (ties by index: a stable sort, as ``jnp.argsort``)."""
    key = torch.where(mask, -avg_grad, torch.inf)
    order = torch.argsort(key, stable=True)
    prio = torch.empty_like(order)
    prio[order] = torch.arange(order.numel(), device=order.device)
    return prio


def _scatter_drop(dst: torch.Tensor, pos: torch.Tensor,
                  src) -> torch.Tensor:
    """``dst.at[pos].set(src, mode="drop")``: rows at pos >= len(dst) are
    dropped. ``src`` is a tensor with ``pos``'s rows or a scalar."""
    keep = pos < dst.shape[0]
    if isinstance(src, torch.Tensor):
        src = src[keep]
    dst[pos[keep]] = src
    return dst


@torch.no_grad()
def refine(
    params: GaussianParams,
    opt_state: Dict,
    stats: DensifyStats,
    step: int,
    cfg: ModelConfig,
    num_train_data: int,
    max_hw: int,
    max_new_per_refine: int = 65536,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianParams, Dict, DensifyStats, RefineInfo]:
    """One refinement pass (densify + cull). Returns new parameter and
    moment tensors (the inputs are not modified), zeroed statistics and the
    counts. ``eps`` or ``generator`` supplies the split offsets."""
    c = params.capacity
    dev = params.means.device
    n_samp = cfg.n_split_samples
    max_new = min(max_new_per_refine, c)
    alive = params.alive
    step = int(step)

    reset_interval = cfg.reset_alpha_every * cfg.refine_every
    do_densify = (step < cfg.stop_split_at
                  and step % reset_interval > num_train_data
                  + cfg.refine_every)
    do_cull = do_densify or (step >= cfg.stop_split_at
                             and cfg.continue_cull_post_densification)

    avg_grad = (stats.grad_norm_sum / torch.clamp(stats.vis_count, min=1.0)
                ) * 0.5 * float(max_hw)
    high = (avg_grad > cfg.densify_grad_thresh) & alive & (
        stats.vis_count > 0)
    scale_max = torch.exp(params.scales).amax(-1)
    big_world = scale_max > cfg.densify_size_thresh
    big_screen = (stats.max_radii_frac > cfg.split_screen_size) & (
        step < cfg.stop_screen_size_at)
    splits = (big_world | big_screen) & high & do_densify
    dups = ~big_world & high & do_densify

    # ---- capacity-aware priority capping: a split needs n_samp slots (net
    # n_samp - 1), a dup one; the highest-absgrad candidates are funded
    opac = torch.sigmoid(params.opacities)
    base_culls = (opac < cfg.cull_alpha_thresh) & alive
    budget = c - int((alive & ~base_culls).sum())
    per_split = max(n_samp - 1, 1)
    splits = splits & (_priority(splits, avg_grad) < budget // per_split)
    dup_budget = budget - int(splits.sum()) * per_split
    dups = dups & (_priority(dups, avg_grad) < dup_budget)

    # ---- candidate packing
    idx = torch.arange(c, device=dev)
    split_rank = torch.cumsum(splits.to(torch.int64), 0) - 1
    n_splits = int(split_rank[-1]) + 1
    dup_rank = torch.cumsum(dups.to(torch.int64), 0) - 1
    n_dups = int(dup_rank[-1]) + 1
    split_slots = n_splits * n_samp
    cand_src = torch.full((max_new,), -1, dtype=torch.int64, device=dev)
    cand_split = torch.zeros((max_new,), dtype=torch.bool, device=dev)
    for copy in range(n_samp):
        pos = torch.where(splits, split_rank * n_samp + copy, max_new)
        _scatter_drop(cand_src, pos, idx)
        _scatter_drop(cand_split, pos, True)
    pos = torch.where(dups, split_slots + dup_rank, max_new)
    _scatter_drop(cand_src, pos, idx)
    n_total_new = split_slots + n_dups
    n_eff = min(n_total_new, max_new)

    # ---- split sampling: mean + R(q) (exp(scale) * eps)
    src = torch.clamp(cand_src, min=0)
    if eps is None:
        eps = torch.randn((max_new, 3), generator=generator, device=dev)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    R = quat_to_rotmat(params.quats[src])
    v = torch.exp(params.scales[src]) * eps
    offset = (R * v[:, None, :]).sum(-1)
    split_col = cand_split[:, None]
    log16 = torch.log(torch.tensor(1.6, dtype=torch.float32, device=dev))
    cand = {
        "means": params.means[src] + torch.where(split_col, offset, 0.0),
        "quats": params.quats[src],
        "scales": torch.where(split_col, params.scales[src] - log16,
                              params.scales[src]),
        "opacities": params.opacities[src],
        "features_dc": params.features_dc[src],
        "features_rest": params.features_rest[src],
    }

    # ---- culling
    culls = (opac < cfg.cull_alpha_thresh) & alive & do_cull
    culls = culls | splits  # split parents die
    after_first_reset = step > cfg.refine_every * cfg.reset_alpha_every
    toobig_world = scale_max > cfg.cull_scale_thresh
    toobig_screen = (stats.max_radii_frac > cfg.cull_screen_size) & (
        step < cfg.stop_screen_size_at)
    culls = culls | ((toobig_world | toobig_screen) & alive
                     & after_first_reset & do_cull)
    alive_after_cull = alive & ~culls

    # ---- slot assignment: the r-th free slot takes the r-th candidate
    free = ~alive_after_cull
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    take = free & (free_rank < n_eff)
    slot_of_rank = torch.full((max_new,), c, dtype=torch.int64, device=dev)
    _scatter_drop(slot_of_rank, torch.where(take, free_rank, max_new), idx)
    placed = slot_of_rank < c
    slots = slot_of_rank[placed]
    new = {}
    for name, arr in params.trainable_dict().items():
        out = arr.clone()
        out[slots] = cand[name][placed]
        new[name] = out
    new_alive = alive_after_cull | take

    # ---- optimizer-state surgery: zero moments of culled + reseeded slots
    touched = take | culls
    new_opt = {}
    for name, gstate in opt_state.items():
        if name not in new:
            new_opt[name] = gstate
            continue
        sel = touched.reshape((c,) + (1,) * (gstate["mu"].ndim - 1))
        new_opt[name] = dict(gstate, mu=torch.where(sel, 0.0, gstate["mu"]),
                             nu=torch.where(sel, 0.0, gstate["nu"]))

    n_take = int(take.sum())
    info = RefineInfo(
        n_alive=int(new_alive.sum()),
        n_culled=int(culls.sum()),
        n_split=n_splits,
        n_dup=n_dups,
        n_added=min(n_eff, n_take),
        n_dropped=max(n_total_new - n_take, 0),
    )
    new_params = params.replace_trainable(new).replace(alive=new_alive)
    return new_params, new_opt, DensifyStats.zeros(c, dev), info


@torch.no_grad()
def maybe_reset_opacities(
    params: GaussianParams,
    opt_state: Dict,
    step: int,
    cfg: ModelConfig,
) -> Tuple[GaussianParams, Dict]:
    """Opacity reset (splatfacto): at step % reset_interval == refine_every,
    while densification is still active (step < stop_split_at), clamp the
    opacity logits to logit(2 * cull_alpha_thresh) and zero the opacities'
    Adam moments. Off its step, the inputs come back unchanged."""
    reset_interval = cfg.reset_alpha_every * cfg.refine_every
    if not (step < cfg.stop_split_at
            and step % reset_interval == cfg.refine_every):
        return params, opt_state
    cap = _inverse_sigmoid(min(2.0 * cfg.cull_alpha_thresh, 0.99))
    gstate = opt_state["opacities"]
    new_opt = dict(opt_state)
    new_opt["opacities"] = dict(gstate, mu=torch.zeros_like(gstate["mu"]),
                                nu=torch.zeros_like(gstate["nu"]))
    return (params.replace(opacities=torch.clamp(params.opacities, max=cap)),
            new_opt)
