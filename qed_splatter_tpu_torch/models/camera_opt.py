"""Learned per-camera pose refinement, SO3xR3 (port of
``models/camera_opt.py``).

The state is one [num_cameras, 6] tensor (translation xyz, then the so(3)
rotation tangent), optimized by its own Adam group ``camera_opt``. The
3x3 products are written out as products and sums, so they stay float32
whatever the TF32 settings.
"""

from __future__ import annotations

import torch


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, m] @ [..., m, n] as an explicit product and sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map so(3) -> SO(3): [..., 3] -> [..., 3, 3].

    Gradient-safe at omega = 0, where every camera delta starts: the
    non-Taylor branch is evaluated at a safe theta, so the untaken 0/0
    never reaches the backward."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    theta_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, 1.0, theta_sq)  # keeps the untaken branch finite
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    return eye + a * K + b * _matmul3(K, K)


def apply_camera_opt(c2w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Compose an OpenGL c2w [..., 3or4, 4] with an SO3xR3 delta [..., 6]:
    the adjustment [R|t] is right-multiplied, so it acts in the camera's
    local frame (nerfstudio's semantics)."""
    R_adj = exp_so3(delta[..., 3:])                       # [..., 3, 3]
    t_adj = delta[..., :3][..., :, None]                  # [..., 3, 1]
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3:4]
    R_new = _matmul3(R, R_adj)
    t_new = _matmul3(R, t_adj) + t
    top = torch.cat([R_new, t_new], dim=-1)               # [..., 3, 4]
    if c2w.shape[-2] == 4:
        return torch.cat([top, c2w[..., 3:4, :]], dim=-2)
    return top


def camera_opt_regularizer(delta: torch.Tensor,
                           trans_penalty: float = 1e-2,
                           rot_penalty: float = 1e-3) -> torch.Tensor:
    """Mean-norm penalty keeping pose deltas small; scalar. sqrt(x^2 + eps):
    the plain norm has a NaN gradient at the zero deltas cameras start from."""
    t = torch.sqrt(torch.sum(delta[..., :3] ** 2, dim=-1) + 1e-12).mean()
    r = torch.sqrt(torch.sum(delta[..., 3:] ** 2, dim=-1) + 1e-12).mean()
    return trans_penalty * t + rot_penalty * r
