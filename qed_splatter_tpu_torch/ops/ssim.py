"""SSIM with an 11x11 gaussian window (port of ``ops/ssim.py``).

torchmetrics' ``StructuralSimilarityIndexMeasure(data_range=1.0,
kernel_size=11)``: gaussian taps with sigma 1.5, *valid* blur (no padding),
per channel, averaged. :func:`ssim` blurs by two band-matrix products (a
dense ``[W, W - k + 1]`` band with the taps on its diagonals), with the
inputs shifted by -data_range/2 so the variance terms E[x^2] - mu^2 cancel
within a magnitude of 0.25. The depthwise convolution, :func:`_ssim_depthwise`,
is its oracle.

Both are full float32 on the GPU only without TF32: ``torch.matmul`` runs
in float32 by default (``torch.backends.cuda.matmul.allow_tf32`` is False),
and :func:`_ssim_depthwise` turns cuDNN's TF32 off around its convolutions,
whose default is TF32. TF32's ~1e-3 relative rounding breaks the variance
cancellation, as bf16 did on the TPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_np(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) / 2.0
    x = np.arange(kernel_size, dtype=np.float64) - half
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, kernel_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """[n, n - k + 1] with the taps on rows j..j+k-1 of column j, so
    ``x @ B`` is the valid-mode blur of x's last axis. Cached (read only);
    the cache may drop a matrix that a caller still holds."""
    g = torch.as_tensor(_gaussian_kernel_np(kernel_size, sigma))
    nout = n - kernel_size + 1
    band = torch.zeros((n, nout), dtype=torch.float32)
    cols = torch.arange(nout)
    for t in range(kernel_size):
        band[cols + t, cols] = g[t]
    return band.to(device)


def ssim_bands(width: int, height: int, kernel_size: int = 11,
               sigma: float = 1.5, device="cpu") -> tuple:
    """(width band, height band) of :func:`ssim` on [height, width]
    images. A CUDA graph that reads them keeps none of them alive, so its
    owner must hold this tuple for as long as it replays."""
    dev = torch.device(device)
    return (_band_matrix(width, kernel_size, sigma, dev),
            _band_matrix(height, kernel_size, sigma, dev))


def _ssim_map_mean(mu_p, mu_t, mu_pp, mu_tt, mu_pt, c1, c2, shift):
    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t
    up = mu_p + shift
    ut = mu_t + shift
    num = (2.0 * up * ut + c1) * (2.0 * cov + c2)
    den = (up * up + ut * ut + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def ssim(
    pred: torch.Tensor,    # [H, W, C] in [0, data_range]
    target: torch.Tensor,
    kernel_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
    bands: Optional[tuple] = None,
) -> torch.Tensor:
    """Scalar mean SSIM (higher is better), band-matmul form. ``bands``:
    :func:`ssim_bands` of this size (else they come from the cache)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    half = 0.5 * data_range
    sp = pred - half
    st = target - half
    stack = torch.stack([sp, st, sp * sp, st * st, sp * st])  # [5, H, W, C]
    h, w = stack.shape[1], stack.shape[2]
    bw, bh = bands or ssim_bands(w, h, kernel_size, sigma, stack.device)
    x = stack.permute(0, 3, 1, 2)                  # [5, C, H, W]
    y = torch.matmul(x, bw)                        # [5, C, H, W']
    y = torch.matmul(y.transpose(-1, -2), bh)      # [5, C, W', H']
    return _ssim_map_mean(y[0], y[1], y[2], y[3], y[4], c1, c2, half)


def _ssim_depthwise(
    pred: torch.Tensor,    # [H, W, C] in [0, data_range]
    target: torch.Tensor,
    kernel_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
) -> torch.Tensor:
    """Depthwise-convolution SSIM without TF32 (the oracle of :func:`ssim`)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    stack = torch.stack(
        [pred, target, pred * pred, target * target, pred * target])
    _, h, w, c = stack.shape
    x = stack.permute(0, 3, 1, 2).reshape(1, 5 * c, h, w)
    g = torch.as_tensor(_gaussian_kernel_np(kernel_size, sigma),
                        device=x.device)
    kh = g.reshape(1, 1, kernel_size, 1).expand(5 * c, 1, kernel_size, 1)
    kw = g.reshape(1, 1, 1, kernel_size).expand(5 * c, 1, 1, kernel_size)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        x = F.conv2d(x, kh, groups=5 * c)
        x = F.conv2d(x, kw, groups=5 * c)
    mu = x.reshape(5, c, x.shape[-2], x.shape[-1])
    return _ssim_map_mean(mu[0], mu[1], mu[2], mu[3], mu[4], c1, c2, 0.0)
