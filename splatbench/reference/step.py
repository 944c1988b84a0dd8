"""The plain training step, Adam and the refine of the reference.

One camera a step, as splatfacto trains: render with the camera's SO3xR3
pose delta, ``(1 - l) L1 + l (1 - SSIM)`` plus ``depth_lambda`` times the
masked depth L1 plus the pose regularizer, autograd, non-finite gradient
elements zeroed, one Adam per group (nerfstudio's exponential-decay
schedules), the camera Adam, then the absgrad statistics. With the model's
``use_bilateral_grid``, the camera's colour grid maps the render before
the loss, ten times the grids' total variation joins the loss, and the
grids take their own Adam group. The refine is splatfacto's
densify-and-cull at fixed capacity. Each piece is a frozen copy of the
port's plain arithmetic (``models/splatfacto.py``, ``ops/ssim.py``,
``engine/optim.py``, ``engine/densify.py``), except the grid's read, which
:mod:`splatbench.reference.appearance` writes in a form of its own; so a
correct program agrees with it to rounding. It imports nothing of the
program.

The state is plain dicts of tensors: ``params`` (means, quats, scales,
opacities, features_dc, features_rest, alive), ``opt`` (group -> count,
mu, nu), ``camera_opt`` and ``camera_opt_state``, ``stats``
(grad_norm_sum, vis_count, max_radii_frac) and ``step``; with the grid on,
``bilateral_grids`` ([num_cameras, gh, gw, gd, 12]) and
``bilateral_grid_state``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from splatbench.reference import appearance, raster
from splatbench.reference.geometry import (
    apply_camera_opt,
    camera_opt_regularizer,
    eval_sh_colors,
    get_viewmat,
    project_gaussians,
    quat_to_rotmat,
)

GROUPS = ("means", "quats", "scales", "opacities", "features_dc",
          "features_rest")
B1, B2 = 0.9, 0.999
F32 = torch.float32


# ---------------------------------------------------------------- render

def render_train(params, c2w, K, width, height, model, step, background,
                 k, tpg, need_absgrad):
    """(rgb, depth, alpha, radii, binning, absgrad eps leaf or None)."""
    dev = params["means"].device
    viewmat = get_viewmat(c2w[None])
    proj = project_gaussians(
        params["means"], params["quats"], torch.exp(params["scales"]),
        viewmat, K[None], width, height, near_plane=model["near_plane"],
        far_plane=model["far_plane"],
        antialiased=model["rasterize_mode"] == "antialiased")
    radii = torch.where(params["alive"], proj.radii[0], 0).to(torch.int32)
    deg = min(int(step) // model["sh_degree_interval"], model["sh_degree"])
    coeffs = torch.cat([params["features_dc"][:, None, :],
                        params["features_rest"]], dim=1)
    mean_ok = torch.isfinite(params["means"]).all(-1, keepdim=True)
    sh_means = torch.where(mean_ok, params["means"], 0.0)
    rgb_g = eval_sh_colors(coeffs, sh_means, c2w[:3, 3], deg,
                           model["sh_degree"])
    opac = torch.sigmoid(params["opacities"]) * proj.compensations[0]
    channels = torch.cat([rgb_g, proj.depths[0][:, None]], dim=-1)
    binning = raster.bin_gaussians(
        proj.means2d[0].detach(), radii, proj.depths[0].detach(), width,
        height, tile_size=model["tile_size"], max_per_tile=k,
        max_tiles_per_gaussian=model["max_tiles_per_gaussian"],
        small_tiles_per_gaussian=tpg)
    packed = torch.cat([proj.means2d[0], proj.conics[0], channels,
                        opac[:, None]], dim=-1)
    eps = None
    if need_absgrad:
        eps = torch.zeros((binning.tile_ranks.shape[0], 2, k), dtype=F32,
                          device=dev, requires_grad=True)
    out, alpha = raster.composite(packed, binning, width, height,
                                  model["tile_size"], eps)
    rgb = torch.clamp(out[..., :3] + (1.0 - alpha) * background, 0.0, 1.0)
    depth = out[..., 3:4]
    depth = torch.where(alpha > 0, depth, depth.max().detach())
    return rgb, depth, alpha, radii, binning, eps


# ---------------------------------------------------------------- losses

def _gaussian_taps(kernel_size=11, sigma=1.5):
    half = (kernel_size - 1) / 2.0
    x = np.arange(kernel_size, dtype=np.float64) - half
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def band(n, device, kernel_size=11):
    """[n, n - k + 1]: ``x @ band`` is the valid-mode blur of x's last
    axis by the 11 taps of sigma 1.5."""
    g = torch.as_tensor(_gaussian_taps(kernel_size))
    nout = n - kernel_size + 1
    b = torch.zeros((n, nout), dtype=F32)
    cols = torch.arange(nout)
    for t in range(kernel_size):
        b[cols + t, cols] = g[t]
    return b.to(device)


def ssim(pred, target, bands):
    c1, c2, half = 0.01 ** 2, 0.03 ** 2, 0.5
    sp, st = pred - half, target - half
    x = torch.stack([sp, st, sp * sp, st * st, sp * st]).permute(0, 3, 1, 2)
    y = torch.matmul(x, bands[0])
    y = torch.matmul(y.transpose(-1, -2), bands[1])
    mu_p, mu_t, mu_pp, mu_tt, mu_pt = y
    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t
    up, ut = mu_p + half, mu_t + half
    num = (2.0 * up * ut + c1) * (2.0 * cov + c2)
    den = (up * up + ut * ut + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def total_loss(rgb, depth, gt_rgb, gt_depth, model, bands):
    l1 = torch.mean(torch.abs(gt_rgb - rgb))
    main = ((1.0 - model["ssim_lambda"]) * l1
            + model["ssim_lambda"] * (1.0 - ssim(rgb, gt_rgb, bands)))
    valid = torch.isfinite(depth) & torch.isfinite(gt_depth) & (gt_depth > 0)
    diff = torch.where(valid, torch.abs(depth - gt_depth), 0.0)
    count = valid.sum()
    dl = torch.where(count > 0, diff.sum() / torch.clamp(count, min=1), 0.0)
    return main + model["depth_lambda"] * dl


# ------------------------------------------------------------------ Adam

def lr_at(cfg: dict, count: int) -> torch.Tensor:
    """nerfstudio's ExponentialDecayScheduler in float32 at ``count``."""
    step = torch.tensor(float(count), dtype=F32)
    lr, lr_final = cfg["lr"], cfg.get("lr_final") or cfg["lr"]
    warmup = cfg.get("warmup_steps", 0)
    if warmup > 0 and count < warmup:
        frac = torch.clamp(step / warmup, 0.0, 1.0)
        return cfg.get("lr_pre_warmup", 1e-8) + (
            lr - cfg.get("lr_pre_warmup", 1e-8)) * torch.sin(
                0.5 * math.pi * frac)
    if lr_final == lr:
        return torch.tensor(lr, dtype=F32)
    t = torch.clamp((step - warmup) / max(cfg["max_steps"] - warmup, 1),
                    0.0, 1.0)
    log_a = torch.log(torch.tensor(lr, dtype=F32))
    log_b = torch.log(torch.tensor(lr_final, dtype=F32))
    return torch.exp((1.0 - t) * log_a + t * log_b)


@torch.no_grad()
def adam_(param, grad, st, cfg):
    lr = lr_at(cfg, int(st["count"])).to(param.device)
    st["count"] += 1
    st["mu"].mul_(B1).add_((1.0 - B1) * grad)
    st["nu"].mul_(B2).add_((1.0 - B2) * (grad * grad))
    c = torch.tensor(float(st["count"]), dtype=F32, device=param.device)
    bc1 = 1.0 - torch.pow(torch.full((), B1, dtype=F32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.full((), B2, dtype=F32, device=c.device), c)
    param.add_((-lr) * ((st["mu"] / bc1)
                        / (torch.sqrt(st["nu"] / bc2) + cfg["eps"])))


# ------------------------------------------------------------------ step

def train_step(S, frame, background, model, optimizers, k, tpg,
               need_absgrad, bands):
    """One step on ``frame`` (rgb, depth, c2w, K, cam_idx, width,
    height): updates ``S`` in place; returns (loss, gradients by leaf,
    the grids' as ``bilateral_grid`` when the model has them)."""
    p = S["params"]
    leaves = {g: p[g].detach().requires_grad_(True) for g in GROUPS}
    cam = S["camera_opt"].detach().requires_grad_(True)
    grids = (S["bilateral_grids"].detach().requires_grad_(True)
             if model["use_bilateral_grid"] else None)
    delta = cam[frame["cam_idx"]]
    c2w = apply_camera_opt(frame["c2w"], delta)
    q = dict(leaves, alive=p["alive"])
    rgb, depth, alpha, radii, binning, eps = render_train(
        q, c2w, frame["K"], frame["width"], frame["height"], model,
        S["step"], background, k, tpg, need_absgrad)
    if grids is not None:
        rgb = appearance.apply_grid(grids[frame["cam_idx"]], rgb)
    loss = total_loss(rgb, depth, frame["rgb"], frame["depth"], model,
                      bands) + camera_opt_regularizer(delta)
    if grids is not None:
        loss = loss + appearance.tv_loss(grids)
    names, inputs = [*GROUPS, "camera_opt"], [*leaves.values(), cam]
    if grids is not None:
        names.append("bilateral_grid")
        inputs.append(grids)
    if eps is not None:
        inputs.append(eps)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    g = {name: (torch.zeros_like(x) if gr is None else gr)
         for name, x, gr in zip(names, inputs, grads)}
    with torch.no_grad():
        for x in g.values():
            torch.nan_to_num_(x, nan=0.0, posinf=0.0, neginf=0.0)
        for name in GROUPS:
            adam_(p[name], g[name], S["opt"][name], optimizers[name])
        adam_(S["camera_opt"], g["camera_opt"], S["camera_opt_state"],
              optimizers["camera_opt"])
        if grids is not None:
            adam_(S["bilateral_grids"], g["bilateral_grid"],
                  S["bilateral_grid_state"], optimizers["bilateral_grid"])
        if eps is not None:
            ag = grads[-1] if grads[-1] is not None else torch.zeros_like(eps)
            absgrad = raster.absgrad_sums(ag, binning, p["means"].shape[0])
            vis = radii > 0
            st = S["stats"]
            st["grad_norm_sum"] += torch.where(
                vis, torch.linalg.vector_norm(absgrad, dim=-1), 0.0)
            st["vis_count"] += vis.to(F32)
            st["max_radii_frac"] = torch.maximum(
                st["max_radii_frac"],
                torch.where(vis, radii.to(F32) / float(
                    max(frame["width"], frame["height"])), 0.0))
    S["step"] += 1
    return loss.detach(), {name: x.detach() for name, x in g.items()}


# ---------------------------------------------------------------- refine

def _priority(mask, avg_grad):
    key = torch.where(mask, -avg_grad, torch.inf)
    order = torch.argsort(key, stable=True)
    prio = torch.empty_like(order)
    prio[order] = torch.arange(order.numel(), device=order.device)
    return prio


def _scatter_drop(dst, pos, src):
    keep = pos < dst.shape[0]
    if isinstance(src, torch.Tensor):
        src = src[keep]
    dst[pos[keep]] = src
    return dst


@torch.no_grad()
def refine_(S, model, num_train, max_hw, generator, max_new_per_refine=65536):
    """Splatfacto's refine at step ``S["step"]`` in place (and the opacity
    reset on its step); returns (culled mask, taken mask, n_split, n_dup)."""
    p, stats = S["params"], S["stats"]
    c = p["means"].shape[0]
    dev = p["means"].device
    n_samp = model["n_split_samples"]
    max_new = min(max_new_per_refine, c)
    alive = p["alive"]
    step = int(S["step"])
    reset_interval = model["reset_alpha_every"] * model["refine_every"]
    do_densify = (step < model["stop_split_at"]
                  and step % reset_interval > num_train
                  + model["refine_every"])
    do_cull = do_densify or (step >= model["stop_split_at"] and model[
        "continue_cull_post_densification"])
    avg_grad = (stats["grad_norm_sum"] / torch.clamp(stats["vis_count"],
                                                     min=1.0)
                ) * 0.5 * float(max_hw)
    high = (avg_grad > model["densify_grad_thresh"]) & alive & (
        stats["vis_count"] > 0)
    scale_max = torch.exp(p["scales"]).amax(-1)
    big_world = scale_max > model["densify_size_thresh"]
    big_screen = (stats["max_radii_frac"] > model["split_screen_size"]) & (
        step < model["stop_screen_size_at"])
    splits = (big_world | big_screen) & high & do_densify
    dups = ~big_world & high & do_densify
    opac = torch.sigmoid(p["opacities"])
    base_culls = (opac < model["cull_alpha_thresh"]) & alive
    budget = c - int((alive & ~base_culls).sum())
    per_split = max(n_samp - 1, 1)
    splits = splits & (_priority(splits, avg_grad) < budget // per_split)
    dup_budget = budget - int(splits.sum()) * per_split
    dups = dups & (_priority(dups, avg_grad) < dup_budget)

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
    n_eff = min(split_slots + n_dups, max_new)

    src = torch.clamp(cand_src, min=0)
    eps = torch.randn((max_new, 3), generator=generator, device=dev)
    R = quat_to_rotmat(p["quats"][src])
    v = torch.exp(p["scales"][src]) * eps
    offset = (R * v[:, None, :]).sum(-1)
    split_col = cand_split[:, None]
    log16 = torch.log(torch.tensor(1.6, dtype=F32, device=dev))
    cand = {
        "means": p["means"][src] + torch.where(split_col, offset, 0.0),
        "quats": p["quats"][src],
        "scales": torch.where(split_col, p["scales"][src] - log16,
                              p["scales"][src]),
        "opacities": p["opacities"][src],
        "features_dc": p["features_dc"][src],
        "features_rest": p["features_rest"][src],
    }
    culls = (opac < model["cull_alpha_thresh"]) & alive & do_cull
    culls = culls | splits
    after_first_reset = step > model["refine_every"] * model[
        "reset_alpha_every"]
    toobig_world = scale_max > model["cull_scale_thresh"]
    toobig_screen = (stats["max_radii_frac"] > model["cull_screen_size"]) & (
        step < model["stop_screen_size_at"])
    culls = culls | ((toobig_world | toobig_screen) & alive
                     & after_first_reset & do_cull)
    free = ~(alive & ~culls)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    take = free & (free_rank < n_eff)
    slot_of_rank = torch.full((max_new,), c, dtype=torch.int64, device=dev)
    _scatter_drop(slot_of_rank, torch.where(take, free_rank, max_new), idx)
    placed = slot_of_rank < c
    slots = slot_of_rank[placed]
    for name in GROUPS:
        p[name][slots] = cand[name][placed]
    p["alive"] = (alive & ~culls) | take
    touched = take | culls
    for name in GROUPS:
        st = S["opt"][name]
        sel = touched.reshape((c,) + (1,) * (st["mu"].ndim - 1))
        st["mu"] = torch.where(sel, 0.0, st["mu"])
        st["nu"] = torch.where(sel, 0.0, st["nu"])
    for key in stats:
        stats[key] = torch.zeros_like(stats[key])
    if step < model["stop_split_at"] and step % reset_interval == model[
            "refine_every"]:
        x = 2.0 * model["cull_alpha_thresh"]
        x = min(x, 0.99)
        p["opacities"] = torch.clamp(p["opacities"],
                                     max=math.log(x / (1.0 - x)))
        S["opt"]["opacities"]["mu"].zero_()
        S["opt"]["opacities"]["nu"].zero_()
    return culls, take, n_splits, n_dups
