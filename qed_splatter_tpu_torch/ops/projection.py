"""Batched perspective (EWA) projection of 3D gaussians to screen space.

Port of ``qed_splatter_tpu.ops.projection``; the same elementwise float32
arithmetic in the same order over a ``[C cameras, N gaussians]`` grid:

- cov2d = J W Sigma W^T J^T with the 1.3x frustum-clamped Jacobian;
- ``classic`` adds a 0.3 px screen blur; ``antialiased`` also returns the
  opacity compensation sqrt(det(cov2d) / det(cov2d + 0.3 I));
- radius = ceil(3 sqrt(lambda_max)) as int32;
- validity: near/far plane, ``det_blur > 1e-6``, image-bounds overlap, and
  finite parameters (non-finite rows are contained, never rendered).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ProjectionResult(NamedTuple):
    """Screen-space gaussians, all [C, N, ...]; invalid entries radius 0."""

    means2d: torch.Tensor        # [C, N, 2] pixel coordinates
    depths: torch.Tensor         # [C, N] camera-space z
    conics: torch.Tensor         # [C, N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor          # [C, N] int32 conservative pixel radius
    compensations: torch.Tensor  # [C, N] antialiasing opacity factor
    valid: torch.Tensor          # [C, N] bool


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Unit-normalize [..., 4] (w, x, y, z) quaternions -> [..., 3, 3].

    NaN-safe at q == 0: ``sqrt(max(|q|^2, eps))`` keeps the backward finite
    where ``max(norm(q), eps)`` would give 0/0."""
    sq = torch.sum(quats * quats, dim=-1, keepdim=True)
    q = quats / torch.sqrt(torch.clamp(sq, min=1e-24))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def covariance3d_sqrt(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """M = R diag(scales): Sigma = M M^T."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def _sum3(terms):
    # left-to-right, as the JAX package's Python ``sum`` over three terms
    return (terms[0] + terms[1]) + terms[2]


def project_gaussians(
    means: torch.Tensor,        # [N, 3] world
    quats: torch.Tensor,        # [N, 4] wxyz (need not be normalized)
    scales: torch.Tensor,       # [N, 3] positive world-space scales
    viewmats: torch.Tensor,     # [C, 4, 4] world-to-camera (OpenCV, +z forward)
    Ks: torch.Tensor,           # [C, 3, 3] intrinsics
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    antialiased: bool = False,
    radius_clip: float = 0.0,
) -> ProjectionResult:
    """Project N gaussians into C cameras (dense [C, N] output)."""
    f32 = torch.float32
    means = means.to(f32)
    quats = quats.to(f32)
    scales = scales.to(f32)
    # Containment: a gaussian whose parameters went non-finite must neither
    # render nor emit gradients.
    row_ok = (
        torch.isfinite(means).all(-1)
        & torch.isfinite(quats).all(-1)
        & torch.isfinite(scales).all(-1)
    )                                            # [N]
    means = torch.where(row_ok[:, None], means, 0.0)
    quats = torch.where(
        row_ok[:, None], quats,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f32, device=quats.device),
    )
    scales = torch.where(row_ok[:, None], scales, 1.0)
    R = viewmats[:, :3, :3].to(f32)              # [C, 3, 3]
    t = viewmats[:, :3, 3].to(f32)               # [C, 3]
    fx = Ks[:, 0, 0].to(f32)[:, None]            # [C, 1]
    fy = Ks[:, 1, 1].to(f32)[:, None]
    cx = Ks[:, 0, 2].to(f32)[:, None]
    cy = Ks[:, 1, 2].to(f32)[:, None]

    # camera-space means [C, N, 3] as explicit multiply-adds (no matmul:
    # full float32 whatever the TF32 settings)
    p_cam = torch.stack(
        [
            _sum3([R[:, None, i, j] * means[None, :, j] for j in range(3)])
            + t[:, None, i]
            for i in range(3)
        ],
        dim=-1,
    )
    z = p_cam[..., 2]
    in_depth = (z > near_plane) & (z < far_plane)
    z_safe = torch.where(in_depth, z, 1.0)

    # frustum-clamped normalized coords for the EWA Jacobian (1.3x tan-fov)
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.clamp(p_cam[..., 0] / z_safe, -lim_x, lim_x) * z_safe
    ty = torch.clamp(p_cam[..., 1] / z_safe, -lim_y, lim_y) * z_safe

    means2d = torch.stack(
        [
            fx * p_cam[..., 0] / z_safe + cx,
            fy * p_cam[..., 1] / z_safe + cy,
        ],
        dim=-1,
    )

    # camera-frame covariance factor RM[i][k]: [C, N]
    M = covariance3d_sqrt(quats, scales)         # [N, 3, 3]
    RMr = [
        [
            _sum3([R[:, None, i, j] * M[None, :, j, k] for j in range(3)])
            for k in range(3)
        ]
        for i in range(3)
    ]

    def dotrow(i, l):
        return _sum3([RMr[i][k] * RMr[l][k] for k in range(3)])

    # J = [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]]
    inv_z = 1.0 / z_safe
    j00 = fx * inv_z
    j11 = fy * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j12 = -fy * ty * inv_z * inv_z

    s00 = dotrow(0, 0)
    s01 = dotrow(0, 1)
    s02 = dotrow(0, 2)
    s11 = dotrow(1, 1)
    s12 = dotrow(1, 2)
    s22 = dotrow(2, 2)

    # cov2d = J S J^T (symmetric 2x2: a = xx, b = xy, c = yy)
    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)

    det_orig = a * c - b * b
    a_blur = a + eps2d
    c_blur = c + eps2d
    det_blur = a_blur * c_blur - b * b

    # A PSD cov2d has det_blur >= 0.09 exactly; a tiny or negative computed
    # value is f32 cancellation on a needle splat. Guard with ``where``, not
    # a max-clamp, whose backward overflows to inf (0 * inf = NaN).
    det_ok = det_blur > 1e-6
    det_safe = torch.where(det_ok, det_blur, 1.0)
    inv_det = 1.0 / det_safe

    if antialiased:
        comp_ok = det_ok & (det_orig > 0)
        ratio = torch.where(comp_ok, det_orig, 1.0) * inv_det
        compensations = torch.where(
            comp_ok, torch.sqrt(torch.clamp(ratio, min=1e-24)), 0.0
        )
    else:
        compensations = torch.ones_like(det_blur)

    conics = torch.stack(
        [c_blur * inv_det, -b * inv_det, a_blur * inv_det], dim=-1)

    # conservative extent: 3 sigma of the dominant eigenvalue of blurred cov2d
    mid = 0.5 * (a_blur + c_blur)
    lambda_max = mid + torch.sqrt(torch.clamp(mid * mid - det_blur, min=0.01))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda_max))

    inside = (
        (means2d[..., 0] + radius_f > 0)
        & (means2d[..., 0] - radius_f < width)
        & (means2d[..., 1] + radius_f > 0)
        & (means2d[..., 1] - radius_f < height)
    )
    valid = (
        in_depth & det_ok & inside & (radius_f > radius_clip)
        & row_ok[None, :]
    )

    radii = torch.where(valid, radius_f, 0.0).to(torch.int32)
    return ProjectionResult(
        means2d=means2d,
        depths=z,
        conics=conics,
        radii=radii,
        compensations=compensations,
        valid=valid,
    )
