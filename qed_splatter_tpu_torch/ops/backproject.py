"""Depth-map unprojection and point projection (port of
``ops/backproject.py``).

``backproject_depth`` turns a depth map into world points, ``colorize_points``
projects a point cloud into a batch of RGB-D frames in one pass and keeps the
depth-consistent colour samples, ``project_points`` gives pixel coordinates.
They run on the device of their inputs, in float32 (the JAX package asks
for ``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _rigid(p: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """p @ R^T + t for [..., N, 3] points and [..., 3, 3] R, [..., 3] t that
    broadcast; a float32 matmul (PyTorch keeps TF32 out of matmuls unless
    ``torch.backends.cuda.matmul.allow_tf32`` is set), which on the CPU
    rounds as XLA's dot does."""
    return torch.matmul(p, R.transpose(-1, -2)) + t[..., None, :]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as XLA contracts it: a re-projected pixel
    centre lands on a rounding tie of ``rint``, where one rounding more
    picks the neighbouring pixel."""
    return torch.addcmul(c, a, b)


def backproject_depth(
    depth: torch.Tensor,     # [H, W] metric depth (0 / negative = invalid)
    K: torch.Tensor,         # [3, 3] intrinsics
    c2w_cv: torch.Tensor,    # [4, 4] OpenCV camera-to-world
    depth_max: float,
    stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points [P, 3], valid [P]) with P = ceil(H/stride) * ceil(W/stride);
    invalid entries carry zeros. Pixel centres at (u + 0.5, v + 0.5)."""
    dev = depth.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w_cv = torch.as_tensor(c2w_cv, dtype=torch.float32, device=dev)
    d = depth[::stride, ::stride]
    h, w = d.shape
    vs = torch.arange(h, dtype=torch.float32, device=dev) * stride + 0.5
    us = torch.arange(w, dtype=torch.float32, device=dev) * stride + 0.5
    vv, uu = torch.meshgrid(vs, us, indexing="ij")        # [h, w]
    z = d.reshape(-1)
    valid = torch.isfinite(z) & (z > 0.0) & (z <= depth_max)
    z = torch.where(valid, z, 0.0)
    x = (uu.reshape(-1) - K[0, 2]) / K[0, 0] * z
    y = (vv.reshape(-1) - K[1, 2]) / K[1, 1] * z
    p_cam = torch.stack([x, y, z], dim=-1)
    p_world = _rigid(p_cam, c2w_cv[:3, :3], c2w_cv[:3, 3])
    return torch.where(valid[:, None], p_world, 0.0), valid


def colorize_points(
    positions: torch.Tensor,  # [N, 3] world
    images: torch.Tensor,     # [B, H, W, 3] float in [0, 1]
    depths: torch.Tensor,     # [B, H, W] metric depth (0 / negative = invalid)
    w2c: torch.Tensor,        # [B, 4, 4] OpenCV world-to-camera
    Ks: torch.Tensor,         # [B, 3, 3]
    depth_max: float,
    abs_tol: float,
    rel_tol: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the points into every frame of the batch at once and keep a
    frame's colour where the point is in front of the camera, inside the
    image and within max(abs_tol, rel_tol * z) of the measured depth.

    Returns (colour sums [N, 3], sample counts [N]), float32 sums over the
    batch; callers divide, and chunk the frames to bound memory."""
    b, h, w, _ = images.shape
    p_cam = _rigid(positions[None], w2c[:, :3, :3], w2c[:, :3, 3])  # [B, N, 3]
    z = p_cam[..., 2]
    zok = torch.isfinite(z) & (z > 1e-6) & (z <= depth_max)
    z_safe = torch.where(zok, z, 1.0)
    u = _fma(Ks[:, None, 0, 0], p_cam[..., 0] / z_safe, Ks[:, None, 0, 2])
    v = _fma(Ks[:, None, 1, 1], p_cam[..., 1] / z_safe, Ks[:, None, 1, 2])
    inside = (torch.isfinite(u) & torch.isfinite(v) & (u >= -0.5)
              & (u < w - 0.5) & (v >= -0.5) & (v < h - 0.5))
    # rint: round half to even, as jnp.rint
    ui = torch.clamp(torch.nan_to_num(torch.round(u)), 0, w - 1).long()
    vi = torch.clamp(torch.nan_to_num(torch.round(v)), 0, h - 1).long()
    frame = torch.arange(b, device=positions.device)[:, None] * (h * w)
    flat = frame + vi * w + ui                                   # [B, N]
    measured = depths.reshape(-1)[flat]
    tol = torch.clamp(rel_tol * z_safe, min=abs_tol)
    ok = (zok & inside & (measured > 0.0)
          & ((measured - z_safe).abs() <= tol))
    col = images.reshape(-1, 3)[flat]                            # [B, N, 3]
    sums = torch.where(ok[..., None], col, 0.0).sum(0)
    return sums, ok.to(torch.float32).sum(0)


def project_points(
    positions: torch.Tensor,  # [N, 3] world
    w2c: torch.Tensor,        # [4, 4] OpenCV world-to-camera
    K: torch.Tensor,          # [3, 3]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points -> (u, v, camera z); u and v NaN where the point is not
    in front of the camera or the projection is not finite."""
    p_cam = _rigid(positions, w2c[:3, :3], w2c[:3, 3])
    z = p_cam[:, 2]
    valid = torch.isfinite(z) & (z > 1e-6)
    z_safe = torch.where(valid, z, 1.0)
    u = _fma(K[0, 0], p_cam[:, 0] / z_safe, K[0, 2])
    v = _fma(K[1, 1], p_cam[:, 1] / z_safe, K[1, 2])
    nan = torch.tensor(float("nan"), device=positions.device)
    u = torch.where(valid & torch.isfinite(u), u, nan)
    v = torch.where(valid & torch.isfinite(v), v, nan)
    return u, v, z
