"""Fixed-capacity gaussian state (port of ``models/gaussians.py``).

Every field has capacity ``C`` rows plus an ``alive`` mask, as in the JAX
package, so checkpoints and densification map one to one. Parameterizations
match the reference: ``scales`` in log space, ``opacities`` as logits,
``quats`` unnormalized (wxyz), colors as SH with a separate dc band.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from qed_splatter_tpu_torch import resolve_device
from qed_splatter_tpu_torch.ops.knn import mean_knn_distance
from qed_splatter_tpu_torch.ops.sh import num_sh_bases

# SH degree-0 basis constant: rgb = SH_C0 * dc + 0.5  =>  dc = (rgb - 0.5)/SH_C0
SH_C0 = 0.28209479177387814

FIELDS = ("means", "quats", "scales", "opacities", "features_dc",
          "features_rest", "alive")
# the trainable fields: one optimizer group each
GROUPS = FIELDS[:-1]


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """Invert the dc SH band: float RGB in [0,1] -> dc coefficient."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    return dc * SH_C0 + 0.5


@dataclasses.dataclass
class GaussianParams:
    """Gaussian parameters at fixed capacity C (field names = the
    reference's optimizer groups, plus the ``alive`` slot mask)."""

    means: torch.Tensor          # [C, 3] world positions
    quats: torch.Tensor          # [C, 4] wxyz, unnormalized
    scales: torch.Tensor         # [C, 3] log-scale
    opacities: torch.Tensor      # [C] logit-opacity
    features_dc: torch.Tensor    # [C, 3] SH dc band
    features_rest: torch.Tensor  # [C, K-1, 3] higher SH bands
    alive: torch.Tensor          # [C] bool slot occupancy

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round((self.features_rest.shape[1] + 1) ** 0.5)) - 1

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GaussianParams":
        return GaussianParams(
            **{f: getattr(self, f).to(device) for f in FIELDS})

    def trainable_dict(self) -> dict:
        """The six optimizer parameter groups (reference config.py:45-68)."""
        return {g: getattr(self, g) for g in GROUPS}

    def replace_trainable(self, d: dict) -> "GaussianParams":
        return self.replace(**{g: d[g] for g in GROUPS})


def from_jax_arrays(d: dict, device="cuda") -> GaussianParams:
    """GaussianParams from the seven fields of the JAX ``GaussianParams``
    as numpy arrays (e.g. ``{f: np.asarray(getattr(p, f)) for f in FIELDS}``),
    carried across unchanged."""
    dev = resolve_device(device)
    return GaussianParams(
        **{f: torch.tensor(np.asarray(d[f]), device=dev) for f in FIELDS})


def _round_capacity(n: int, multiple: int = 256) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def random_quats(n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Uniform random unit quaternions (splatfacto's random_quat_tensor)."""
    u, v, w = torch.rand((3, n), generator=generator, device=device)
    return torch.stack(
        [
            torch.sqrt(1 - u) * torch.sin(2 * math.pi * v),
            torch.sqrt(1 - u) * torch.cos(2 * math.pi * v),
            torch.sqrt(u) * torch.sin(2 * math.pi * w),
            torch.sqrt(u) * torch.cos(2 * math.pi * w),
        ],
        dim=-1,
    )


def init_from_points(
    points: np.ndarray,           # [N, 3] float world positions (seed PLY)
    rgb: Optional[np.ndarray],    # [N, 3] uint8 colors or None
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    capacity_headroom: float = 4.0,
    seed: int = 42,
    init_opacity: float = 0.1,
    device="cuda",
) -> GaussianParams:
    """Seed-point initialization: means from points, dc SH from colors,
    log-scales from the mean 3-NN distance, random quats (from a
    ``torch.Generator`` seeded with ``seed``; they differ from the JAX
    package's), opacity logit(init_opacity)."""
    dev = resolve_device(device)
    n = points.shape[0]
    if capacity is None:
        capacity = _round_capacity(int(n * capacity_headroom))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < num points {n}")
    k = num_sh_bases(sh_degree)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32

    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    means = torch.zeros((capacity, 3), dtype=f32, device=dev)
    means[:n] = pts
    dist = torch.clamp(mean_knn_distance(pts, k=3), min=1e-7)
    scales = torch.zeros((capacity, 3), dtype=f32, device=dev)
    scales[:n] = torch.log(dist)[:, None]
    quats = random_quats(capacity, gen, dev)
    opacities = torch.full(
        (capacity,), float(np.log(init_opacity / (1 - init_opacity))),
        dtype=f32, device=dev,
    )
    features_dc = torch.zeros((capacity, 3), dtype=f32, device=dev)
    if rgb is not None:
        col = torch.as_tensor(np.asarray(rgb), device=dev).to(f32) / 255.0
        features_dc[:n] = rgb_to_sh_dc(col)
    features_rest = torch.zeros((capacity, k - 1, 3), dtype=f32, device=dev)
    alive = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    alive[:n] = True
    return GaussianParams(
        means=means,
        quats=quats,
        scales=scales,
        opacities=opacities,
        features_dc=features_dc,
        features_rest=features_rest,
        alive=alive,
    )


def init_random(
    num_points: int = 50_000,
    random_scale: float = 10.0,
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    capacity_headroom: float = 4.0,
    seed: int = 42,
    init_opacity: float = 0.1,
    device="cuda",
) -> GaussianParams:
    """Random-cube initialization: means uniform in (rand - 0.5) *
    ``random_scale``, random colours, 3-NN scales. The points and colours
    come from ``np.random.default_rng(seed)`` (they differ from the JAX
    package's)."""
    rng = np.random.default_rng(seed)
    pts = ((rng.random((num_points, 3)) - 0.5) * random_scale).astype(
        np.float32)
    rgb = (rng.random((num_points, 3)) * 255.0).astype(np.uint8)
    return init_from_points(pts, rgb, sh_degree=sh_degree, capacity=capacity,
                            capacity_headroom=capacity_headroom, seed=seed,
                            init_opacity=init_opacity, device=device)


# the identity rotation, held by every dead slot a growth adds: a zero
# quaternion's normalisation has a NaN gradient that poisons the backward
UNIT_QUAT = (1.0, 0.0, 0.0, 0.0)


def pad_rows(x: torch.Tensor, new_capacity: int, value=0) -> torch.Tensor:
    """``x`` with rows appended up to ``new_capacity``, filled with
    ``value`` (a scalar or one row)."""
    pad = x.new_empty((new_capacity - x.shape[0],) + tuple(x.shape[1:]))
    pad[...] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def grow_capacity(params: GaussianParams,
                  new_capacity: int) -> GaussianParams:
    """Host-side capacity growth: every field padded with dead slots (zero
    rows, ``alive`` False) holding the unit quaternion. New tensors; the
    old ones are untouched."""
    if new_capacity <= params.capacity:
        return params
    return GaussianParams(**{
        f: pad_rows(getattr(params, f), new_capacity,
                    UNIT_QUAT if f == "quats" else 0)
        for f in FIELDS})
