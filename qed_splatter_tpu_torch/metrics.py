"""Quality metrics: RGB (PSNR / SSIM / LPIPS), depth and point clouds (port
of ``metrics.py``).

- :class:`RGBMetrics`: PSNR with data range 1, SSIM with an 11-tap window,
  LPIPS (``ops/lpips.py``); uint8 inputs are normalized to [0, 1] first.
  LPIPS needs pretrained weights that are not shipped: they come from an
  ``.npz`` (``lpips_weights`` or ``QED_LPIPS_WEIGHTS``), and without one
  ``rgb_lpips`` is NaN, as in the JAX package.
- :func:`depth_metrics`: (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) over
  the finite pixels with gt > 0.1; NaN when no pixel is valid.
- :func:`full_eval_metrics` (the eval row's keys) and :func:`avg_min_scale`.
- :class:`PDMetrics`: point-cloud accuracy (the 90th percentile of the
  distances from the reconstruction to the reference) and completeness (the
  percentage of reference points within 0.05 of the reconstruction), the
  distances from the host core (``native.py``); :func:`mean_angular_error`.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qed_splatter_tpu_torch import native
from qed_splatter_tpu_torch.ops.ssim import ssim as ssim_fn


def to_float_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float / 255; floats pass through as float32."""
    img = torch.as_tensor(img)
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / 255.0
    return img.to(torch.float32)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((to_float_image(pred) - to_float_image(target)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


class RGBMetrics:
    """(PSNR, SSIM, LPIPS) of [H, W, 3] images (float [0, 1] or uint8);
    LPIPS is NaN without a weights file."""

    def __init__(self, lpips_weights: Optional[str] = None):
        self._lpips = None
        path = lpips_weights or os.environ.get("QED_LPIPS_WEIGHTS")
        if path and os.path.exists(path):
            from qed_splatter_tpu_torch.ops.lpips import LPIPS

            self._lpips = LPIPS.from_npz(path)

    @property
    def has_lpips(self) -> bool:
        return self._lpips is not None

    def __call__(self, pred: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        p = to_float_image(pred)
        t = to_float_image(target).to(p.device)
        lp = (self._lpips(p, t) if self._lpips is not None
              else torch.tensor(float("nan")))
        return (psnr(p, t), ssim_fn(p, t, kernel_size=11, data_range=1.0),
                lp)


class DepthMetricValues(NamedTuple):
    abs_rel: torch.Tensor
    sq_rel: torch.Tensor
    rmse: torch.Tensor
    rmse_log: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    a3: torch.Tensor


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor,
                  tolerance: float = 0.1) -> DepthMetricValues:
    """Masked means over the finite pixels with gt > ``tolerance``; every
    value NaN when there is none. rmse_log leaves out pixels with a
    non-positive prediction."""
    pred = torch.as_tensor(pred).to(torch.float32)
    gt = torch.as_tensor(gt).to(torch.float32).to(pred.device)
    valid = torch.isfinite(pred) & torch.isfinite(gt) & (gt > tolerance)
    n = valid.sum()
    safe_n = torch.clamp(n, min=1)

    def masked_mean(x):
        return torch.where(valid, x, 0.0).sum() / safe_n

    p = torch.where(valid, pred, 1.0)
    g = torch.where(valid, gt, 1.0)
    thresh = torch.maximum(g / p, p / g)
    a1 = masked_mean((thresh < 1.25).to(torch.float32))
    a2 = masked_mean((thresh < 1.25 ** 2).to(torch.float32))
    a3 = masked_mean((thresh < 1.25 ** 3).to(torch.float32))
    rmse = torch.sqrt(masked_mean((g - p) ** 2))
    logs_ok = valid & (p > 0) & (g > 0)
    n_logs = torch.clamp(logs_ok.sum(), min=1)
    lg = torch.where(logs_ok, torch.log(g) - torch.log(
        torch.where(p > 0, p, 1.0)), 0.0)
    rmse_log = torch.sqrt((lg ** 2).sum() / n_logs)
    abs_rel = masked_mean(torch.abs(g - p) / g)
    sq_rel = masked_mean((g - p) ** 2 / g)
    nan = torch.tensor(float("nan"), device=pred.device)
    empty = n == 0
    return DepthMetricValues(*[torch.where(empty, nan, v) for v in (
        abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3)])


def _nn_dist(queries: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """Nearest-neighbour distances from the host core."""
    return native.nn_distances_native(np.asarray(queries, np.float32),
                                      np.asarray(refs, np.float32))


def calculate_accuracy(reconstructed: np.ndarray, reference: np.ndarray,
                       percentile: float = 90.0) -> float:
    """The ``percentile`` of the distances from each reconstructed point to
    the reference."""
    return float(np.percentile(_nn_dist(reconstructed, reference),
                               percentile))


def calculate_completeness(reconstructed: np.ndarray, reference: np.ndarray,
                           threshold: float = 0.05) -> float:
    """Percentage of reference points within ``threshold`` of the
    reconstruction."""
    d = _nn_dist(reference, reconstructed)
    return float(np.sum(d < threshold) / len(d) * 100.0)


class PDMetrics:
    """(accuracy, completeness) of a reconstructed point cloud against a
    reference scan."""

    def __call__(self, pred_points: np.ndarray, gt_points: np.ndarray
                 ) -> Tuple[float, float]:
        return (calculate_accuracy(pred_points, gt_points),
                calculate_completeness(pred_points, gt_points))


def mean_angular_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-row angle between two sets of unit vectors [B, C]."""
    dots = torch.clamp((gt * pred).sum(1), -1.0, 1.0)
    return torch.arccos(dots)


def full_eval_metrics(
    pred_rgb: torch.Tensor,
    gt_rgb: torch.Tensor,
    pred_depth: Optional[torch.Tensor] = None,
    gt_depth: Optional[torch.Tensor] = None,
    rgb_metrics: Optional[RGBMetrics] = None,
    gaussian_count: Optional[int] = None,
    avg_min_scale: Optional[float] = None,
) -> Dict[str, float]:
    """The eval metrics dict, with the JAX package's keys."""
    rgb_metrics = rgb_metrics or RGBMetrics()
    p, s, lp = rgb_metrics(pred_rgb, gt_rgb)
    pf = to_float_image(pred_rgb)
    mse = torch.mean((pf - to_float_image(gt_rgb).to(pf.device)) ** 2)
    out = {"rgb_mse": float(mse), "rgb_psnr": float(p),
           "rgb_ssim": float(s), "rgb_lpips": float(lp)}
    if gaussian_count is not None:
        out["gaussian_count"] = int(gaussian_count)
    if pred_depth is not None and gt_depth is not None:
        dm = depth_metrics(pred_depth, gt_depth)
        out.update({f"depth_{k}": float(v) for k, v in dm._asdict().items()})
    if avg_min_scale is not None:
        out["avg_min_scale"] = float(avg_min_scale)
    return out


def avg_min_scale(scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean of exp(last scale axis) over the alive gaussians."""
    s = torch.exp(scales[..., -1])
    n = torch.clamp(alive.sum(), min=1)
    return torch.where(alive, s, 0.0).sum() / n
