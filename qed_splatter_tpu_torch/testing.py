"""Synthetic camera helpers for drives and tests (numpy, host-side)."""

from __future__ import annotations

import numpy as np


def orbit_c2w_opengl(
    radius: float, azimuth: float, elevation: float, target=(0.0, 0.0, 3.0)
) -> np.ndarray:
    """OpenGL camera-to-world orbiting ``target``, looking at it. [4, 4]."""
    target = np.asarray(target, dtype=np.float64)
    eye = target + radius * np.array(
        [
            np.cos(elevation) * np.sin(azimuth),
            np.sin(elevation),
            -np.cos(elevation) * np.cos(azimuth),
        ]
    )
    forward = target - eye
    forward /= np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    # OpenGL convention: camera looks down -z, y up.
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def orbit_intrinsics(width: int, height: int, focal_scale: float = 0.8):
    """Pinhole K [3, 3] float32 with f = focal_scale * max(W, H), centred
    principal point (the orbit render's intrinsics)."""
    f = focal_scale * max(width, height)
    return np.array(
        [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32
    )
