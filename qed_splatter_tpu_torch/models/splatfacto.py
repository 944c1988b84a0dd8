"""The splat model's forward render (port of ``models/splatfacto.py``).

:func:`render` with ``train=False`` is the serving path: what an eval, an
orbit render or a viewer frame runs for one camera. It chains
``get_viewmat`` -> ``project_gaussians`` -> ``eval_sh_colors`` ->
``bin_gaussians`` (window gather kernel) -> ``rasterize_tiles_pallas``
(rank gather + compositing kernel), then blends the background and fills
empty depth. On CUDA tensors the hand-written kernels run; on CPU tensors
their plain versions. The training render (random background, gradient
plan, absgrad) and the losses come with the backward kernels.
"""

from __future__ import annotations

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
from qed_splatter_tpu_torch.ops.tiles import bin_gaussians

# nerfstudio's fixed eval background (splatfacto draws a random background
# during training, this constant for eval renders)
EVAL_BACKGROUND = (0.1490, 0.1647, 0.2157)


@dataclasses.dataclass
class RenderOutputs:
    """One camera's render (the JAX ``RenderOutputs`` forward fields)."""

    rgb: torch.Tensor                   # [H, W, 3] in [0, 1]
    depth: torch.Tensor                 # [H, W, 1]
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


def background_color(cfg: ModelConfig, device) -> torch.Tensor:
    """The eval background: white, black, or the fixed eval colour."""
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    if cfg.background_color == "black":
        return torch.zeros(3, device=device)
    return torch.tensor(EVAL_BACKGROUND, dtype=torch.float32, device=device)


@torch.no_grad()
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
) -> RenderOutputs:
    """Forward render of one camera on ``device`` (params, ``c2w`` and ``K``
    are moved there; numpy or tensors). ``crop_box`` (models.crop.CropBox)
    excludes gaussians; an all-empty crop gives the background image."""
    if train:
        raise NotImplementedError(
            "the training render needs the compositing backward, which the "
            "port does not have yet; render with train=False")
    dev = resolve_device(device)
    params = params.to(dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)

    alive = params.alive
    if crop_box is not None:
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

    # an eval render always carries depth: RGB+D channels
    channels = torch.cat([rgb_g, proj.depths[0][:, None]], dim=-1)

    binning = bin_gaussians(
        proj.means2d[0],
        radii,
        proj.depths[0],
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
        )

    bg = background_color(cfg, dev)
    rgb = out.render[..., :3] + (1.0 - out.alpha) * bg
    rgb = torch.clamp(rgb, 0.0, 1.0)

    depth = out.render[..., 3:4]
    # where nothing rendered, fall back to the max depth
    depth = torch.where(out.alpha > 0, depth, depth.max())

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
