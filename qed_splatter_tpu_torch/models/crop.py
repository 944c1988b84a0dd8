"""Eval-time crop box (port of ``models/crop.py``).

An oriented box: gaussians outside are excluded from eval renders by ANDing
the ``alive`` mask, so an empty crop renders the background image, which is
what :func:`get_empty_outputs` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CropBox:
    """World point p is inside iff |R (p - center)| <= size/2 componentwise
    (R rows are the box axes)."""

    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    size: Tuple[float, float, float] = (2.0, 2.0, 2.0)
    rotation: Optional[Tuple[float, ...]] = None  # row-major 3x3; None = I

    def rotation_matrix(self) -> np.ndarray:
        if self.rotation is None:
            return np.eye(3, dtype=np.float32)
        return np.asarray(self.rotation, dtype=np.float32).reshape(3, 3)

    def within(self, points: torch.Tensor) -> torch.Tensor:
        """[N, 3] world points -> [N] bool."""
        dev = points.device
        R = torch.as_tensor(self.rotation_matrix(), device=dev)
        c = torch.tensor(self.center, dtype=torch.float32, device=dev)
        half = torch.tensor(self.size, dtype=torch.float32, device=dev) / 2.0
        d = points - c
        # (p - c) @ R^T as products and sums: full f32 whatever TF32 says
        local = (d[:, None, :] * R[None, :, :]).sum(-1)
        return (local.abs() <= half).all(-1)


def get_empty_outputs(width: int, height: int,
                      background: torch.Tensor) -> dict:
    """Background-only outputs shaped like RenderOutputs' user fields."""
    dev = background.device
    return {
        "rgb": background.expand(height, width, 3),
        "depth": torch.zeros((height, width, 1), device=dev),
        "accumulation": torch.zeros((height, width, 1), device=dev),
        "background": background,
    }
