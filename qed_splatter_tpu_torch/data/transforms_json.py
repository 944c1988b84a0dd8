"""Nerfstudio ``transforms.json`` dataparser (a copy of
``qed_splatter_tpu.data.transforms_json`` on the port's ``Camera``; numpy
only).

Rebuilds SURVEY D12 (nerfstudio's ``Nerfstudio`` dataparser) plus the
reference's subclass behavior (reference dataparser.py:13-74):

- global + per-frame intrinsics (fl_x/fl_y/cx/cy, w/h, distortion params),
- OpenGL c2w poses from ``transform_matrix`` (4x4 or 3x4),
- pose orientation ("up"/"vertical"/"pca"/"none"), centering
  ("poses"/"focus"/"none"),
  auto-scaling to the unit box — with the unscaled-scene switches the
  reference documents (dataparser.py:16-18, README.md:20-25),
- train/eval split (fraction / interval / all),
- ``depth_file_path`` with ``depth_unit_scale_factor`` (default mm -> m,
  dataparser.py:15) *times the pose scale factor* (nerfstudio DepthDataset
  semantics),
- ``ply_file_path`` seed points transformed by the same transform + scale
  (dataparser.py:40-50) with the uint8 color semantics of
  ``_load_ply_colors`` (dataparser.py:58-74, via data.ply).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from qed_splatter_tpu_torch.configs import DataConfig
from qed_splatter_tpu_torch.data.ply import read_ply
from qed_splatter_tpu_torch.ops.camera import Camera


@dataclasses.dataclass
class Frame:
    """One dataset frame (camera + file paths)."""

    camera: Camera
    image_path: Path
    depth_path: Optional[Path]
    mask_path: Optional[Path]


@dataclasses.dataclass
class ParsedScene:
    """Dataparser outputs (nerfstudio DataparserOutputs equivalent)."""

    frames: List[Frame]
    train_indices: np.ndarray
    eval_indices: np.ndarray
    transform_matrix: np.ndarray       # [3, 4] applied to world
    scale_factor: float                # pose scaling applied
    depth_unit_scale_factor: float
    points: Optional[np.ndarray]       # [N, 3] seed points (transformed)
    points_rgb: Optional[np.ndarray]   # [N, 3] uint8


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        if c > 0:
            return np.eye(3)
        # 180 degrees: any orthogonal axis
        axis = np.eye(3)[np.argmin(np.abs(a))]
        v = np.cross(a, axis)
        v /= np.linalg.norm(v)
        return 2.0 * np.outer(v, v) - np.eye(3)
    skew = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def _focus_of_attention(poses: np.ndarray) -> np.ndarray:
    """Least-squares point closest to all optical axes (nerfstudio
    'focus' centering). poses: [N, 3or4, 4] OpenGL c2w."""
    origins = poses[:, :3, 3]
    directions = -poses[:, :3, 2]  # OpenGL looks down -z
    m = np.eye(3)[None] - directions[:, :, None] * directions[:, None, :]
    mt_m = m.sum(0)
    mt_b = (m @ origins[:, :, None]).sum(0)
    return np.linalg.solve(mt_m, mt_b)[:, 0]


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> np.ndarray:
    """Return the [3, 4] world transform nerfstudio would apply."""
    origins = poses[:, :3, 3]
    if center_method == "poses":
        translation = origins.mean(0)
    elif center_method == "focus":
        translation = _focus_of_attention(poses)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method}")

    if method == "up" or method == "vertical":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            # nerfstudio's "vertical" (the 4th option of the reference
            # setup snippet, the reference README.md:20-25): gravity is
            # the direction most orthogonal to every camera RIGHT axis —
            # hand-held cameras tilt up/down freely but rarely roll, so
            # their x-axes stay near-horizontal. Solve
            # min_{|v|=1} sum_i (x_i . v)^2 = smallest right-singular
            # vector of the stacked x-axes; fall back to mean-up when the
            # x-axes are degenerate (all parallel: rank < 2), and
            # sign-align with mean up.
            x_axes = poses[:, :3, 0]
            _, s, vh = np.linalg.svd(x_axes, full_matrices=False)
            if s.shape[0] == 3 and s[1] > 1e-17:
                vertical = vh[2, :]
                if np.dot(vertical, up) < 0:
                    vertical = -vertical
                up = vertical / np.linalg.norm(vertical)
        rotation = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "pca":
        centered = origins - origins.mean(0)
        _, eigvec = np.linalg.eigh(centered.T @ centered)
        eigvec = eigvec[:, ::-1]  # descending
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        rotation = eigvec.T
        if rotation[2, 2] < 0:
            rotation = np.diag([1.0, -1.0, -1.0]) @ rotation
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"unknown orientation_method {method}")

    transform = np.concatenate(
        [rotation, rotation @ -translation[:, None]], axis=1
    )
    return transform.astype(np.float64)


def _apply_transform(poses: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """[N, 4, 4] poses through a [3, 4] world transform."""
    t44 = np.eye(4)
    t44[:3, :4] = transform
    return (t44[None] @ poses)[:, :4, :]


def _split_indices(n: int, cfg: DataConfig):
    """nerfstudio eval-split semantics."""
    i_all = np.arange(n)
    if cfg.eval_mode == "all" or n == 1:
        return i_all, i_all
    if cfg.eval_mode == "interval":
        mask = (i_all % cfg.eval_interval) == 0
        return i_all[~mask], i_all[mask]
    # fraction: evenly spaced train subset
    num_train = int(np.ceil(n * cfg.train_split_fraction))
    if num_train >= n:
        return i_all, i_all[-1:]
    i_train = np.linspace(0, n - 1, num_train)
    i_train = np.unique(np.round(i_train).astype(int))
    i_eval = np.setdiff1d(i_all, i_train)
    if len(i_eval) == 0:
        i_eval = i_all[-1:]
    return i_train, i_eval


def _resolve(dataset_dir: Path, rel: str) -> Path:
    p = Path(rel)
    return p if p.is_absolute() else dataset_dir / p


def parse_transforms(cfg: DataConfig) -> ParsedScene:
    """Load and normalize a nerfstudio dataset directory."""
    data = Path(cfg.data).expanduser()
    if data.is_file():
        transforms_path, dataset_dir = data, data.parent
    else:
        dataset_dir = data
        transforms_path = data / "transforms.json"
    with open(transforms_path, encoding="utf-8") as f:
        meta = json.load(f)

    frames_meta = meta["frames"]
    if cfg.max_images is not None:
        frames_meta = frames_meta[: cfg.max_images]

    poses = []
    for fr in frames_meta:
        m = np.array(fr["transform_matrix"], dtype=np.float64)
        if m.shape == (3, 4):
            m = np.concatenate([m, [[0, 0, 0, 1]]], axis=0)
        poses.append(m)
    poses = np.stack(poses)  # [N, 4, 4]

    transform = auto_orient_and_center_poses(
        poses, method=cfg.orientation_method, center_method=cfg.center_method
    )
    poses = _apply_transform(poses, transform)

    # Compose the dataset's pre-applied transform (ns-process-data/COLMAP
    # datasets record it as ``applied_transform``) into the dataparser
    # transform — nerfstudio nerfstudio_dataparser semantics: the poses
    # already live in the applied frame, but ``ply_file_path`` seed points
    # and the recorded transform (used for inverse world-coordinate
    # exports) are in the ORIGINAL frame.
    if "applied_transform" in meta:
        at = np.array(meta["applied_transform"], dtype=np.float64)
        at44 = np.eye(4)
        at44[: at.shape[0], :4] = at
        t44 = np.eye(4)
        t44[:3, :4] = transform
        transform = (t44 @ at44)[:3, :4]

    scale_factor = 1.0
    if cfg.auto_scale_poses:
        maxabs = float(np.max(np.abs(poses[:, :3, 3])))
        if maxabs > 0:
            scale_factor = 1.0 / maxabs
    scale_factor *= cfg.scale_factor
    poses[:, :3, 3] *= scale_factor

    def _get(fr, key, default=None):
        if key in fr:
            return fr[key]
        return meta.get(key, default)

    frames: List[Frame] = []
    for i, fr in enumerate(frames_meta):
        fl_x = float(_get(fr, "fl_x"))
        fl_y = float(_get(fr, "fl_y", fl_x))
        cx = float(_get(fr, "cx"))
        cy = float(_get(fr, "cy"))
        w = int(_get(fr, "w", int(2 * cx)))
        h = int(_get(fr, "h", int(2 * cy)))
        dist = np.array(
            [float(_get(fr, k, 0.0) or 0.0)
             for k in ("k1", "k2", "k3", "k4", "p1", "p2")],
            dtype=np.float32,
        )
        cam_model = str(_get(fr, "camera_model", "OPENCV") or "OPENCV")
        # fisheye images always need the equidistant->perspective remap,
        # even with all-zero coefficients (theta_d = atan(r) != r)
        has_dist = np.any(dist != 0) or cam_model == "OPENCV_FISHEYE"
        cam = Camera(
            fx=fl_x, fy=fl_y, cx=cx, cy=cy, width=w, height=h,
            c2w=poses[i, :3, :4].astype(np.float32), cam_idx=i,
            distortion=dist if has_dist else None,
            camera_model=cam_model,
        )
        depth_path = (
            _resolve(dataset_dir, fr["depth_file_path"])
            if "depth_file_path" in fr else None
        )
        mask_path = (
            _resolve(dataset_dir, fr["mask_path"])
            if "mask_path" in fr else None
        )
        frames.append(
            Frame(
                camera=cam,
                image_path=_resolve(dataset_dir, fr["file_path"]),
                depth_path=depth_path,
                mask_path=mask_path,
            )
        )

    # nerfstudio's optional explicit split lists take precedence over the
    # eval_mode heuristics (nerfstudio_dataparser train/val_filenames)
    train_names = meta.get("train_filenames")
    val_names = meta.get("val_filenames") or meta.get("test_filenames")
    if train_names or val_names:
        by_name = {str(fr["file_path"]): i
                   for i, fr in enumerate(frames_meta)}
        i_train = np.asarray(
            sorted(by_name[n] for n in (train_names or []) if n in by_name),
            dtype=np.int64,
        )
        i_eval = np.asarray(
            sorted(by_name[n] for n in (val_names or []) if n in by_name),
            dtype=np.int64,
        )
        if i_train.size == 0:
            i_train = np.setdiff1d(np.arange(len(frames)), i_eval)
        if i_eval.size == 0:
            i_eval = np.setdiff1d(np.arange(len(frames)), i_train)
    else:
        i_train, i_eval = _split_indices(len(frames), cfg)

    points = points_rgb = None
    ply_rel = meta.get("ply_file_path")
    if cfg.load_3D_points and ply_rel:
        ply_path = _resolve(dataset_dir, ply_rel)
        if ply_path.exists():
            ply = read_ply(ply_path)
            if len(ply) > 0:
                # homogeneous transform then scale (dataparser.py:40-50)
                pts = ply.positions.astype(np.float64)
                pts = pts @ transform[:3, :3].T + transform[:3, 3]
                pts = (pts * scale_factor).astype(np.float32)
                points = pts
                points_rgb = ply.colors_uint8()

    return ParsedScene(
        frames=frames,
        train_indices=i_train,
        eval_indices=i_eval,
        transform_matrix=transform.astype(np.float32),
        scale_factor=scale_factor,
        depth_unit_scale_factor=cfg.depth_unit_scale_factor,
        points=points,
        points_rgb=points_rgb,
    )
