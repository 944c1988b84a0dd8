"""Image undistortion at load time (SURVEY D12); a copy of
``qed_splatter_tpu.data.undistort``, which the port may not import.

nerfstudio's dataparser carries OpenCV distortion coefficients from
``transforms.json`` (k1 k2 k3 k4 p1 p2) and undistorts images when caching
(the render path then assumes an ideal pinhole). Without OpenCV here, the
standard forward-distortion remap is done in numpy: for every *undistorted*
output pixel, distort its normalized coordinates and bilinearly sample the
source image — identical semantics to ``cv2.undistort`` with the same K.

Two camera models (nerfstudio ``camera_model``):
- ``OPENCV`` (default): radial k1..k4 + tangential p1 p2 pinhole model
- ``OPENCV_FISHEYE``: the cv2.fisheye equidistant model — theta = atan(r),
  theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8), point maps
  to x * theta_d / r (p1/p2 unused)
"""

from __future__ import annotations

import numpy as np


def _distort(x: np.ndarray, y: np.ndarray, dist: np.ndarray):
    """OpenCV radial(k1..k4)/tangential(p1,p2) model on normalized coords."""
    k1, k2, k3, k4, p1, p2 = [float(d) for d in dist[:6]]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _distort_fisheye(x: np.ndarray, y: np.ndarray, dist: np.ndarray):
    """cv2.fisheye equidistant model (OPENCV_FISHEYE, k1..k4) on
    normalized coords: distorted radius = theta_d(atan(r))."""
    k1, k2, k3, k4 = [float(d) for d in dist[:4]]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = np.where(r > 1e-9, theta_d / np.maximum(r, 1e-9), 1.0)
    return x * scale, y * scale


def undistort_map(width: int, height: int, K: np.ndarray,
                  dist: np.ndarray, camera_model: str = "OPENCV"):
    """(map_x, map_y) source pixel coordinates for each output pixel."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u, v = np.meshgrid(
        np.arange(width, dtype=np.float64),
        np.arange(height, dtype=np.float64),
    )
    x = (u - cx) / fx
    y = (v - cy) / fy
    if camera_model == "OPENCV_FISHEYE":
        xd, yd = _distort_fisheye(x, y, dist)
    else:
        xd, yd = _distort(x, y, dist)
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(np.float32)


def _bilinear_sample(img: np.ndarray, mx: np.ndarray, my: np.ndarray
                     ) -> np.ndarray:
    """Sample img [H, W, C] at float coords; out-of-bounds clamp to edge."""
    h, w = img.shape[:2]
    x0 = np.clip(np.floor(mx).astype(np.int32), 0, w - 1)
    y0 = np.clip(np.floor(my).astype(np.int32), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    wx = np.clip(mx - x0, 0.0, 1.0)[..., None]
    wy = np.clip(my - y0, 0.0, 1.0)[..., None]
    im = img.astype(np.float32)
    top = im[y0, x0] * (1 - wx) + im[y0, x1] * wx
    bot = im[y1, x0] * (1 - wx) + im[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def undistort_image(img: np.ndarray, K: np.ndarray, dist: np.ndarray,
                    nearest: bool = False,
                    camera_model: str = "OPENCV") -> np.ndarray:
    """Undistort [H, W, C] (or [H, W]) image; dtype preserved.

    ``nearest=True`` for depth/mask images (no cross-edge blending)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    mx, my = undistort_map(w, h, K, dist, camera_model)
    if nearest:
        xi = np.clip(np.rint(mx).astype(np.int32), 0, w - 1)
        yi = np.clip(np.rint(my).astype(np.int32), 0, h - 1)
        out = img[yi, xi]
    else:
        out = _bilinear_sample(img, mx, my)
        if np.issubdtype(img.dtype, np.integer):
            out = np.clip(np.rint(out), 0, np.iinfo(img.dtype).max)
    out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out
