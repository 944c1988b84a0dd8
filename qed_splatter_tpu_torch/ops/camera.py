"""Camera math: OpenGL -> OpenCV view matrices and the pinhole camera bundle.

Port of ``qed_splatter_tpu.ops.camera``: ``get_viewmat`` flips the local y/z
axes of an OpenGL camera-to-world pose and takes the analytic rigid inverse,
giving the rasterizer's OpenCV world-to-camera (+z forward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Column flip that maps OpenGL (y-up, z-back) camera axes to OpenCV
# (y-down, z-forward): multiplying R by it on the right negates the y and z
# basis vectors.
_FLIP_YZ = (1.0, -1.0, -1.0)


def get_viewmat(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world [..., 3or4, 4] -> OpenCV world-to-camera [..., 4, 4]."""
    flip = torch.tensor(_FLIP_YZ, dtype=c2w.dtype, device=c2w.device)
    R = c2w[..., :3, :3] * flip                      # flip columns
    t = c2w[..., :3, 3:4]
    R_inv = R.transpose(-1, -2)
    # -R^T t as explicit products: a batched matmul here could run in TF32
    t_inv = -(R_inv * t.transpose(-1, -2)).sum(-1, keepdim=True)
    top = torch.cat([R_inv, t_inv], dim=-1)          # [..., 3, 4]
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype, device=c2w.device
    ).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera bundle (host-side container; numpy fields).

    Images are undistorted at load time, so the render path assumes zero
    ``distortion``; ``camera_model`` names the undistortion model.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    c2w: np.ndarray  # [3or4, 4] OpenGL camera-to-world
    cam_idx: Optional[int] = None
    distortion: Optional[np.ndarray] = None
    camera_model: str = "OPENCV"
    metadata: Optional[dict] = None

    def intrinsics_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def rescaled(self, scale: float) -> "Camera":
        """Camera with output resolution rescaled by ``scale``; dimensions
        floor (int(w * scale)) to match the image downscalers."""
        return dataclasses.replace(
            self,
            fx=self.fx * scale,
            fy=self.fy * scale,
            cx=self.cx * scale,
            cy=self.cy * scale,
            width=int(self.width * scale),
            height=int(self.height * scale),
        )
