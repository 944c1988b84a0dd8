"""Spherical-harmonics color evaluation, degrees 0..3 (port of ``ops/sh.py``).

Coefficients ``[N, K, 3]`` with ``K = (deg+1)**2``, dc first; view direction
normalize(mean - camera position) in the world frame; the active degree is
applied as a band mask so one code path serves every step of the schedule;
color = SH + 0.5 clamped at 0. Float32 throughout: the band contraction is
an elementwise product and sum, never a (TF32-prone) matmul.
"""

from __future__ import annotations

import torch

# Real SH basis constants (same basis as the 3DGS/gsplat kernels).
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(dirs: torch.Tensor, max_degree: int) -> torch.Tensor:
    """Real SH basis [..., (max_degree+1)^2] for unit directions [..., 3]."""
    if not 0 <= max_degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {max_degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if max_degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if max_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if max_degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def degree_band_mask(active_degree, max_degree: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """[K] mask, 1 for bases whose band (floor(sqrt(i))) <= active_degree.
    ``active_degree`` may be an int or a 0-d tensor."""
    k = num_sh_bases(max_degree)
    band = torch.floor(torch.sqrt(
        torch.arange(k, device=device, dtype=torch.float32))).to(torch.int32)
    return (band <= torch.as_tensor(active_degree, device=device)).to(dtype)


def eval_sh_colors(
    coeffs: torch.Tensor,      # [N, K, 3]
    means: torch.Tensor,       # [N, 3]
    campos: torch.Tensor,      # [3]
    active_degree,             # int or 0-d tensor in [0, max_degree]
    max_degree: int,
) -> torch.Tensor:
    """SH -> RGB [N, 3] for one camera position: clamp(SH + 0.5, min=0)."""
    d = means - campos[None, :]
    # sqrt(max(|d|^2, eps)): NaN-safe backward at d == 0
    sq = torch.sum(d * d, dim=-1, keepdim=True)
    d = d / torch.sqrt(torch.clamp(sq, min=1e-24))
    basis = eval_sh_basis(d, max_degree)  # [N, K]
    mask = degree_band_mask(active_degree, max_degree, dtype=basis.dtype,
                            device=basis.device)
    basis = basis * mask[None, :]
    colors = torch.sum(basis[:, :, None] * coeffs, dim=1) + 0.5
    return torch.clamp(colors, min=0.0)
