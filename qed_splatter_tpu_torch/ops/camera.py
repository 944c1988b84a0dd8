"""Camera math: OpenGL -> OpenCV view matrices and the pinhole camera bundle.

Port of ``qed_splatter_tpu.ops.camera``: ``get_viewmat`` flips the local y/z
axes of an OpenGL camera-to-world pose and takes the analytic rigid inverse,
giving the rasterizer's OpenCV world-to-camera (+z forward);
``opengl_c2w_to_opencv_w2c`` is the same flip on a numpy 4x4 pose, for the
init-pointcloud tool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def get_viewmat(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world [..., 3or4, 4] -> OpenCV world-to-camera [..., 4, 4]."""
    # the column flip (1, -1, -1) from OpenGL (y-up, z-back) to OpenCV
    # (y-down, z-forward) axes, built on the device: the train step is
    # captured in a CUDA graph, where a copy from the host is not allowed
    flip = torch.ones(3, dtype=c2w.dtype, device=c2w.device)
    flip[1:].fill_(-1.0)     # fill_: no host scalar copied in
    R = c2w[..., :3, :3] * flip                      # flip columns
    t = c2w[..., :3, 3:4]
    R_inv = R.transpose(-1, -2)
    # -R^T t as explicit products: a batched matmul here could run in TF32
    t_inv = -(R_inv * t.transpose(-1, -2)).sum(-1, keepdim=True)
    top = torch.cat([R_inv, t_inv], dim=-1)          # [..., 3, 4]
    bottom = torch.zeros(4, dtype=c2w.dtype, device=c2w.device)
    bottom[3:].fill_(1.0)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def opengl_c2w_to_opencv_w2c(c2w_opengl: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world [4, 4] -> OpenCV world-to-camera [4, 4]
    (numpy, inverted in float64, returned as float32)."""
    c2w = np.array(c2w_opengl, dtype=np.float64, copy=True)
    c2w[:3, 1:3] *= -1.0
    return np.linalg.inv(c2w).astype(np.float32)


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
