"""The splat model: render and training losses (port of
``models/splatfacto.py``).

:func:`render` chains ``get_viewmat`` -> ``project_gaussians`` ->
``eval_sh_colors`` -> ``bin_gaussians`` (window gather kernel) ->
``rasterize_tiles_pallas`` (rank gather + compositing kernels), then blends
the background and fills empty depth. With ``train=False`` it is the
serving path (an eval, an orbit render or a viewer frame) and runs without
autograd. With ``train=True`` it is the first half of the training step:
differentiable, with splatfacto's random background drawn from a
``torch.Generator`` and the absgrad side channel. On CUDA tensors the
hand-written kernels run; on CPU tensors their plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from qed_splatter_tpu_torch import resolve_device
from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.models.gaussians import GaussianParams
from qed_splatter_tpu_torch.ops.camera import get_viewmat
from qed_splatter_tpu_torch.ops.projection import project_gaussians
from qed_splatter_tpu_torch.ops.rasterize import rasterize_tiles
from qed_splatter_tpu_torch.ops.rasterize_pallas import rasterize_tiles_pallas
from qed_splatter_tpu_torch.ops.sh import eval_sh_colors
from qed_splatter_tpu_torch.ops.ssim import ssim
from qed_splatter_tpu_torch.ops.tiles import bin_gaussians

# nerfstudio's fixed eval background (splatfacto draws a random background
# during training, this constant for eval renders)
EVAL_BACKGROUND = (0.1490, 0.1647, 0.2157)


@dataclasses.dataclass
class RenderOutputs:
    """One camera's render (the JAX ``RenderOutputs`` forward fields)."""

    rgb: torch.Tensor                   # [H, W, 3] in [0, 1]
    depth: Optional[torch.Tensor]       # [H, W, 1] (None: RGB only)
    accumulation: torch.Tensor          # [H, W, 1]
    background: torch.Tensor            # [3]
    radii: torch.Tensor                 # [N] int32
    tile_lists: Optional[torch.Tensor]  # [T, K] ids (None on the rank path)
    num_tiles_x: int
    visible: torch.Tensor               # [N] bool
    # intersections dropped by the max_per_tile cap (sum over tiles)
    tile_overflow: torch.Tensor         # scalar
    # gaussians whose tile bbox exceeded the pair-expansion budget
    bbox_truncated: torch.Tensor        # scalar
    # max uncapped per-tile intersection count
    tile_max_count: torch.Tensor        # scalar


def active_sh_degree(step, sh_degree: int, sh_degree_interval: int):
    """min(step // interval, sh_degree) for an int or a tensor step."""
    if isinstance(step, torch.Tensor):
        return torch.clamp(step // sh_degree_interval, max=sh_degree)
    return min(int(step) // sh_degree_interval, sh_degree)


def background_color(cfg: ModelConfig, device, train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """White, black, or: splatfacto's random colour per training step (drawn
    from ``generator``), the fixed eval colour otherwise."""
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    if cfg.background_color == "black":
        return torch.zeros(3, device=device)
    if train:
        if generator is None:
            raise ValueError("a random training background needs a "
                             "torch.Generator")
        return torch.rand(3, generator=generator, device=device)
    return torch.tensor(EVAL_BACKGROUND, dtype=torch.float32, device=device)


def render(
    params: GaussianParams,
    c2w,                       # [3or4, 4] OpenGL camera-to-world
    K,                         # [3, 3]
    width: int,
    height: int,
    cfg: ModelConfig,
    step=0,
    train: bool = False,
    crop_box=None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    tile_eps: Optional[torch.Tensor] = None,
    absgrad_seed: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """Render one camera on ``device`` (params, ``c2w`` and ``K`` are moved
    there; numpy or tensors).

    ``train=False``: no autograd, the fixed eval background, RGB+D.
    ``crop_box`` (models.crop.CropBox) excludes gaussians; an all-empty crop
    gives the background image.

    ``train=True``: differentiable in the parameters and ``c2w``; the
    random background needs ``generator``; depth is rendered when
    ``cfg.output_depth_during_training``. The absgrad side channel is
    ``absgrad_seed`` (zeros [C, 2]) on the kernel path and ``tile_eps``
    (zeros [T, K, 2], with ``absgrad_scatter``) on the plain path
    (``cfg.use_pallas=False``). ``cfg.mixed_precision`` composites with
    the bf16 operand kernels when training (eval renders stay float32; the
    plain path ignores it, as the JAX package's does)."""
    grad_mode = contextlib.nullcontext() if train else torch.no_grad()
    with grad_mode:
        return _render(params, c2w, K, width, height, cfg, step, train,
                       crop_box, device, generator, tile_eps, absgrad_seed)


def _render(params, c2w, K, width, height, cfg, step, train, crop_box,
            device, generator, tile_eps, absgrad_seed):
    render_depth = cfg.output_depth_during_training or not train
    dev = resolve_device(device)
    params = params.to(dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)

    alive = params.alive
    if crop_box is not None and not train:
        alive = alive & crop_box.within(params.means)

    viewmat = get_viewmat(c2w[None])                        # [1, 4, 4]
    campos = c2w[:3, 3]
    proj = project_gaussians(
        params.means,
        params.quats,
        torch.exp(params.scales),
        viewmat,
        K[None],
        width,
        height,
        near_plane=cfg.near_plane,
        far_plane=cfg.far_plane,
        antialiased=(cfg.rasterize_mode == "antialiased"),
    )
    # dead capacity slots never rasterize
    radii = torch.where(alive, proj.radii[0], 0).to(torch.int32)

    if cfg.sh_degree > 0:
        deg = active_sh_degree(step, cfg.sh_degree, cfg.sh_degree_interval)
        coeffs = torch.cat(
            [params.features_dc[:, None, :], params.features_rest], dim=1)
        # a non-finite mean must not leak through the view-direction basis
        mean_ok = torch.isfinite(params.means).all(-1, keepdim=True)
        sh_means = torch.where(mean_ok, params.means, 0.0)
        rgb_g = eval_sh_colors(coeffs, sh_means, campos, deg, cfg.sh_degree)
    else:
        rgb_g = torch.sigmoid(params.features_dc)

    opac = torch.sigmoid(params.opacities) * proj.compensations[0]

    channels = rgb_g
    if render_depth:
        channels = torch.cat([rgb_g, proj.depths[0][:, None]], dim=-1)

    # the binning is integer work: it takes no gradient
    binning = bin_gaussians(
        proj.means2d[0].detach(),
        radii,
        proj.depths[0].detach(),
        width,
        height,
        tile_size=cfg.tile_size,
        max_per_tile=cfg.max_per_tile,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        small_tiles_per_gaussian=cfg.small_tiles_per_gaussian,
        # the kernel path addresses slabs by depth rank and never needs ids
        with_id_lists=not cfg.use_pallas,
        use_pallas=None if cfg.use_pallas else False,
    )
    if cfg.use_pallas:
        out = rasterize_tiles_pallas(
            binning.tile_ranks,
            binning.order,
            proj.means2d[0],
            proj.conics[0],
            channels,
            opac,
            width,
            height,
            binning.num_tiles_x,
            tile_size=cfg.tile_size,
            tile_counts=binning.tile_counts,
            absgrad_seed=absgrad_seed,
            mixed_precision=cfg.mixed_precision and train,
        )
    else:
        out = rasterize_tiles(
            binning.tile_lists,
            proj.means2d[0],
            proj.conics[0],
            channels,
            opac,
            width,
            height,
            binning.num_tiles_x,
            tile_size=cfg.tile_size,
            tile_eps=tile_eps,
        )

    bg = background_color(cfg, dev, train, generator)
    rgb = out.render[..., :3] + (1.0 - out.alpha) * bg
    rgb = torch.clamp(rgb, 0.0, 1.0)

    depth = None
    if render_depth:
        depth = out.render[..., 3:4]
        # where nothing rendered, fall back to the (detached) max depth
        far = depth.max().detach()
        depth = torch.where(out.alpha > 0, depth, far)

    counts = binning.tile_counts
    return RenderOutputs(
        rgb=rgb,
        depth=depth,
        accumulation=out.alpha,
        background=bg,
        radii=radii,
        tile_lists=binning.tile_lists,
        num_tiles_x=binning.num_tiles_x,
        visible=radii > 0,
        tile_overflow=torch.clamp(counts - cfg.max_per_tile, min=0).sum(),
        bbox_truncated=binning.num_truncated,
        tile_max_count=counts.max(),
    )


def photometric_loss(
    pred: torch.Tensor,     # [H, W, 3]
    gt: torch.Tensor,       # [H, W, 3] float in [0, 1]
    ssim_lambda: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Splatfacto's main loss, (1 - l) L1 + l (1 - SSIM), with the optional
    pixel mask applied multiplicatively as the reference does."""
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    l1 = torch.mean(torch.abs(gt - pred))
    s = 1.0 - ssim(pred, gt)
    return (1.0 - ssim_lambda) * l1 + ssim_lambda * s


def depth_l1_loss(
    depth_pred: torch.Tensor,   # [H, W, 1]
    depth_gt: torch.Tensor,     # [H, W, 1] metric depth (0 = invalid)
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked L1 depth loss: multiply by the optional mask, keep the
    finite, positive GT pixels, mean |pred - gt| over them; 0 when no pixel
    is valid."""
    if mask is not None:
        depth_pred = depth_pred * mask
        depth_gt = depth_gt * mask
    valid = (torch.isfinite(depth_pred) & torch.isfinite(depth_gt)
             & (depth_gt > 0.0))
    diff = torch.where(valid, torch.abs(depth_pred - depth_gt), 0.0)
    count = valid.sum()
    return torch.where(count > 0, diff.sum() / torch.clamp(count, min=1),
                       0.0)


def scale_regularization(params: GaussianParams,
                         max_gauss_ratio: float) -> torch.Tensor:
    """Splatfacto's anisotropy penalty: 0.1 * mean over alive of
    (max(exp-scale ratio, r_max) - r_max)."""
    s = torch.exp(params.scales)
    ratio = s.amax(-1) / torch.clamp(s.amin(-1), min=1e-12)
    pen = torch.clamp(ratio, min=max_gauss_ratio) - max_gauss_ratio
    alive = params.alive
    n = torch.clamp(alive.sum(), min=1)
    return 0.1 * torch.where(alive, pen, 0.0).sum() / n


def total_loss(
    outputs: RenderOutputs,
    gt_rgb: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    params: GaussianParams,
    cfg: ModelConfig,
    step: int,
    mask: Optional[torch.Tensor] = None,
):
    """(scalar, dict of terms): the photometric loss, the scale
    regularization every 10th step when enabled, and the weighted depth L1."""
    losses = {}
    losses["main_loss"] = photometric_loss(
        outputs.rgb, gt_rgb, cfg.ssim_lambda, mask)
    if cfg.use_scale_regularization:
        losses["scale_reg"] = (
            scale_regularization(params, cfg.max_gauss_ratio)
            if int(step) % 10 == 0 else outputs.rgb.new_zeros(()))
    if gt_depth is not None and outputs.depth is not None:
        losses["depth_loss"] = cfg.depth_lambda * depth_l1_loss(
            outputs.depth, gt_depth, mask)
    total = sum(losses.values())
    return total, losses
