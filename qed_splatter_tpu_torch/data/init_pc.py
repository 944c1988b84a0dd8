"""``init-pc``: an initialization point cloud backprojected from RGB-D frames
(port of ``data/init_pc.py``).

Mode 1 (default): each frame's depth map is backprojected on ``device``
(``ops/backproject.py``) with the OpenGL -> OpenCV extrinsics, voxel
downsampled by the host core (``native.py``) and cached as one PLY per frame
(a rerun resumes from the frames already cached); the cached clouds are then
merged in one bounded-memory pass and voxel downsampled once more. Mode 2
(``colorize=True``): the cloud is projected into batches of RGB-D frames on
``device``; colour samples within max(abs_tol, rel_tol * z) of the measured
depth are averaged into uint8 colours, and points no frame sees stay black.
The result is written as a PLY, and ``transforms.json``'s ``ply_file_path``
is pointed at it unless ``update_transforms`` is off. Images (PNG or
baseline JPEG) are decoded by ``data/image.py``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from qed_splatter_tpu_torch import resolve_device
from qed_splatter_tpu_torch.data import png
from qed_splatter_tpu_torch.data.image import read_image
from qed_splatter_tpu_torch.data.dataset import load_depth
from qed_splatter_tpu_torch.data.ply import PlyData, read_ply, write_ply
from qed_splatter_tpu_torch.native import (
    voxel_downsample_native as voxel_downsample,
)
from qed_splatter_tpu_torch.ops.backproject import (
    backproject_depth,
    colorize_points,
)
from qed_splatter_tpu_torch.ops.camera import opengl_c2w_to_opencv_w2c


@dataclasses.dataclass
class InitPcArgs:
    """The tool's flags, with the JAX package's defaults."""

    data: str = ""
    colorize: bool = False
    input_name: str = "sparse_pc.ply"
    output_name: str = "sparse_pc.ply"
    depth_unit_scale_factor: float = 0.001
    cache_dir: Optional[str] = None
    keep_cache: bool = True
    voxel_size: float = 0.05
    merge_voxel_size: float = 0.03
    frame_voxel_size: Optional[float] = 0.05
    max_points: int = 2_000_000
    depth_max: float = 100.0
    stride: int = 4
    depth_tolerance: float = 0.05
    depth_tolerance_rel: float = 0.02
    update_transforms: bool = True


def _resolve_dataset_path(data: str) -> Path:
    path = Path(data).expanduser().resolve()
    if path.is_file() and path.name == "transforms.json":
        return path.parent
    if path.is_dir():
        return path
    raise ValueError(f"Expected a dataset directory or transforms.json: {data}")


def _load_transforms(dataset_path: Path) -> dict:
    p = dataset_path / "transforms.json"
    if not p.exists():
        raise FileNotFoundError(f"No transforms.json found at {p}")
    with open(p, encoding="utf-8") as f:
        return json.load(f)


def _cache_dir(args: InitPcArgs, dataset_path: Path) -> Path:
    return (Path(args.cache_dir).expanduser().resolve() if args.cache_dir
            else dataset_path / "init_pc_cache")


def _frame_intrinsics(contents: dict, frame: dict) -> np.ndarray:
    fl_x = float(frame.get("fl_x", contents["fl_x"]))
    fl_y = float(frame.get("fl_y", contents.get("fl_y", fl_x)))
    cx = float(frame.get("cx", contents["cx"]))
    cy = float(frame.get("cy", contents["cy"]))
    return np.array(
        [[fl_x, 0.0, cx], [0.0, fl_y, cy], [0.0, 0.0, 1.0]], dtype=np.float32)


def _frame_c2w44(frame: dict) -> np.ndarray:
    c2w = np.array(frame["transform_matrix"], dtype=np.float64)
    if c2w.shape == (3, 4):
        c2w = np.concatenate([c2w, [[0, 0, 0, 1]]], axis=0)
    return c2w


def frame_depth(dataset_path: Path, frame: dict,
                depth_unit_scale_factor: float) -> np.ndarray:
    """A frame's metric depth, float32, non-finite and non-positive -> 0."""
    depth = load_depth(dataset_path / frame["depth_file_path"])
    depth = depth * depth_unit_scale_factor
    depth[~np.isfinite(depth) | (depth <= 0.0)] = 0.0
    return depth.astype(np.float32)


def frame_c2w_cv(frame: dict) -> np.ndarray:
    """A frame's OpenCV camera-to-world [4, 4] float32."""
    w2c = opengl_c2w_to_opencv_w2c(_frame_c2w44(frame))
    return np.linalg.inv(w2c.astype(np.float64)).astype(np.float32)


def backproject_frame_np(
    dataset_path: Path,
    contents: dict,
    frame: dict,
    depth_unit_scale_factor: float,
    depth_max: float,
    stride: int,
    frame_voxel_size: Optional[float],
    device="cuda",
) -> Optional[np.ndarray]:
    """One frame -> world points [P, 3] on the host (None when no valid
    depth); backprojected on ``device``, downsampled by the host core."""
    if "depth_file_path" not in frame:
        return None
    depth = frame_depth(dataset_path, frame, depth_unit_scale_factor)
    if not np.any(depth > 0.0):
        return None
    dev = resolve_device(device)
    pts, valid = backproject_depth(
        torch.as_tensor(depth, device=dev),
        _frame_intrinsics(contents, frame), frame_c2w_cv(frame), depth_max,
        stride=stride)
    pts = pts[valid].cpu().numpy()
    if len(pts) == 0:
        return None
    if frame_voxel_size is not None and frame_voxel_size > 0:
        pts, _ = voxel_downsample(pts, frame_voxel_size)
    return pts


def streaming_merge(
    ply_paths: List[Path],
    voxel_size: float = 0.03,
    max_points: int = 2_000_000,
    log=print,
) -> np.ndarray:
    """Fold the cached per-frame clouds into one accumulator, voxel
    downsampling it again whenever it passes ``max_points``: memory stays
    O(max_points + largest frame), and nothing intermediate is written."""
    acc = np.empty((0, 3), np.float32)
    for i, p in enumerate(ply_paths):
        acc = np.concatenate([acc, read_ply(p).positions.astype(np.float32)])
        if len(acc) > max_points:
            before = len(acc)
            acc, _ = voxel_downsample(acc, voxel_size)
            log(f"  merge: re-voxelized {before} -> {len(acc)} points "
                f"after {i + 1}/{len(ply_paths)} frames")
    return acc


def create_pointcloud_from_transforms(args: InitPcArgs, log=print,
                                      device="cuda") -> PlyData:
    dataset_path = _resolve_dataset_path(args.data)
    contents = _load_transforms(dataset_path)
    frames_dir = _cache_dir(args, dataset_path) / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)

    frame_paths: List[Path] = []
    for idx, frame in enumerate(contents["frames"]):
        if "depth_file_path" not in frame:
            continue
        out_path = frames_dir / f"frame_{idx:06d}.ply"
        if out_path.exists():  # resume by existence
            frame_paths.append(out_path)
            continue
        pts = backproject_frame_np(
            dataset_path, contents, frame, args.depth_unit_scale_factor,
            args.depth_max, args.stride, args.frame_voxel_size, device)
        if pts is None:
            log(f"  Skipping frame {idx} (no valid depth)")
            continue
        write_ply(out_path, pts)
        log(f"  Backprojected frame {idx}: {len(pts)} points")
        frame_paths.append(out_path)

    if not frame_paths:
        raise RuntimeError(
            "No valid point clouds could be generated from the dataset.")
    merged = streaming_merge(frame_paths, voxel_size=args.merge_voxel_size,
                             max_points=args.max_points, log=log)
    pos, _ = voxel_downsample(merged, args.voxel_size)
    return PlyData(pos)


def frame_w2c_opencv(frame: dict) -> np.ndarray:
    """A frame's OpenCV world-to-camera [4, 4] float32."""
    w2c44 = np.eye(4, dtype=np.float32)
    w2c44[:3] = opengl_c2w_to_opencv_w2c(_frame_c2w44(frame))[:3]
    return w2c44


def colorize_pointcloud(args: InitPcArgs, pcd: PlyData, log=print,
                        frames_per_batch: int = 8,
                        device="cuda") -> PlyData:
    """Average depth-consistent RGB samples into point colours: frames of
    one resolution are stacked into batches of ``frames_per_batch``, each
    projected in one pass on ``device``; the host decodes the images."""
    dev = resolve_device(device)
    dataset_path = _resolve_dataset_path(args.data)
    contents = _load_transforms(dataset_path)
    positions = pcd.positions.astype(np.float32)
    n = len(positions)

    frames = [
        f for f in contents["frames"]
        if "depth_file_path" in f and "file_path" in f
        and (dataset_path / f["file_path"]).exists()
    ]
    log(f"Colorizing {n} points using {len(frames)} RGB-D frames...")

    pos_dev = torch.as_tensor(positions, device=dev)
    color_sum = np.zeros((n, 3), np.float64)
    color_count = np.zeros((n,), np.float64)
    by_size: dict = {}

    def flush(batch):
        s, c = colorize_batch(pos_dev, batch, args)
        color_sum[:] += s
        color_count[:] += c

    for frame in frames:
        color = png.to_rgb(read_image(dataset_path / frame["file_path"])
                           ).astype(np.float32) / 255.0
        depth = frame_depth(dataset_path, frame, args.depth_unit_scale_factor)
        if color.shape[:2] != depth.shape[:2]:
            log("  Skipping frame with RGB/depth size mismatch")
            continue
        batch = by_size.setdefault(depth.shape, [])
        batch.append((color, depth, frame_w2c_opencv(frame),
                      _frame_intrinsics(contents, frame)))
        if len(batch) >= frames_per_batch:
            flush(batch)
            by_size[depth.shape] = []
    for batch in by_size.values():
        if batch:
            flush(batch)

    colored = color_count > 0
    if not colored.any():
        raise RuntimeError(
            "Colorize failed: no point passed the depth-consistency gate "
            "in any frame (check depth_unit_scale_factor / tolerances).")
    colors = np.zeros((n, 3), dtype=np.uint8)
    mean = color_sum[colored] / color_count[colored, None]
    colors[colored] = np.clip(mean * 255.0, 0.0, 255.0).astype(np.uint8)
    log(f"Colored {int(colored.sum())}/{n} points "
        f"({100.0 * colored.sum() / n:.1f}%)")
    return PlyData(positions, colors)


def colorize_batch(pos_dev: torch.Tensor, batch, args: InitPcArgs):
    """One batch of (colour, depth, w2c, K) frames of one size -> (colour
    sums [N, 3], counts [N]) as float64 numpy."""
    dev = pos_dev.device
    colors, depths, w2cs, Ks = (torch.as_tensor(np.stack(x), device=dev)
                                for x in zip(*batch))
    s, c = colorize_points(pos_dev, colors, depths, w2cs, Ks, args.depth_max,
                           args.depth_tolerance, args.depth_tolerance_rel)
    return (s.cpu().numpy().astype(np.float64),
            c.cpu().numpy().astype(np.float64))


def _update_transforms_ply_path(dataset_path: Path, output_name: str) -> None:
    p = dataset_path / "transforms.json"
    with open(p, encoding="utf-8") as f:
        contents = json.load(f)
    contents["ply_file_path"] = output_name
    with open(p, "w", encoding="utf-8") as f:
        json.dump(contents, f, indent=4)


def main(args: InitPcArgs, log=print, device="cuda") -> Path:
    """Run the tool; returns the written PLY's path."""
    dataset_path = _resolve_dataset_path(args.data)
    output_path = dataset_path / args.output_name

    if args.colorize:
        input_path = dataset_path / args.input_name
        if not input_path.exists():
            raise FileNotFoundError(
                f"Input point cloud not found: {input_path}. "
                "Run without colorize first to backproject depth.")
        pcd = colorize_pointcloud(args, read_ply(input_path), log=log,
                                  device=device)
    else:
        pcd = create_pointcloud_from_transforms(args, log=log, device=device)
        cache_dir = _cache_dir(args, dataset_path)
        if not args.keep_cache and cache_dir.exists():
            shutil.rmtree(cache_dir)

    log(f"Writing {len(pcd)} points to {output_path}")
    write_ply(output_path, pcd.positions, pcd.colors)
    if args.update_transforms:
        _update_transforms_ply_path(dataset_path, args.output_name)
    return output_path
