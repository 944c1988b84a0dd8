"""Full-image RGB-D datamanager (port of ``data/dataset.py``).

Whole-image training, one camera per step, as nerfstudio's
``FullImageDatamanager[DepthDataset]``: images cached host-side as uint8,
depth maps from ``depth_file_path`` scaled by ``depth_unit_scale_factor``
times the pose scale factor into ``depth_image``, and an optional
``mask``. Images (PNG or baseline JPEG) are decoded with
:mod:`qed_splatter_tpu_torch.data.image` (no imaging library); a dataset-level ``downscale_factor`` is PIL's
``BILINEAR`` resize. The camera order is the JAX package's: the same
``np.random.default_rng(seed + process_index)`` epoch permutations.

Depth files may be ``.npy`` / ``.npz`` or 16-bit PNG images; 3-channel
depth collapses to the first channel.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from qed_splatter_tpu_torch.configs import DataConfig
from qed_splatter_tpu_torch.data import png
from qed_splatter_tpu_torch.data.image import read_image
from qed_splatter_tpu_torch.data.transforms_json import (
    Frame,
    ParsedScene,
    parse_transforms,
)
from qed_splatter_tpu_torch.data.undistort import undistort_image


def load_depth(path: Path) -> np.ndarray:
    """Raw depth map as float32 [H, W]."""
    path = Path(path)
    if path.suffix.lower() in {".npy", ".npz"}:
        depth = np.load(path)
        if isinstance(depth, np.lib.npyio.NpzFile):
            depth = depth[list(depth.keys())[0]]
        depth = depth.astype(np.float32)
    else:
        depth = read_image(path).astype(np.float32)
    if depth.ndim == 3:
        depth = depth[..., 0]
    return depth


def load_image_uint8(path: Path, downscale: int = 1) -> np.ndarray:
    """RGB image as uint8 [H, W, 3]."""
    img = png.to_rgb(read_image(path))
    if downscale > 1:
        h, w = img.shape[:2]
        img = png.resize_bilinear(img, w // downscale, h // downscale)
    return img


def _resize_nearest(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * arr.shape[0] / h).astype(int)
    xs = (np.arange(w) * arr.shape[1] / w).astype(int)
    return arr[ys][:, xs]


class FullImageDatamanager:
    """Caches every train/eval image host-side; serves one camera per step.

    ``next_train(step)`` draws cameras without replacement from epoch
    permutations of the training cameras; ``next_train_batch`` draws
    several (view parallelism). ``process_count`` > 1 keeps every
    ``process_count``-th training camera from ``process_index`` on (the
    trainer passes the host's index with ``shard_views_by_process``).
    """

    def __init__(self, cfg: DataConfig, scene: Optional[ParsedScene] = None,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        self.scene = scene if scene is not None else parse_transforms(cfg)
        self.rng = np.random.default_rng(seed + process_index)
        self._cache: Dict[int, Dict] = {}
        self._perm: List[int] = []
        self.depth_scale = (
            self.scene.depth_unit_scale_factor * self.scene.scale_factor
        )
        self.train_indices = self.scene.train_indices
        if process_count > 1:
            self.train_indices = self.train_indices[
                process_index::process_count
            ]
            if len(self.train_indices) == 0:
                self.train_indices = self.scene.train_indices[:1]

    @property
    def num_train(self) -> int:
        return len(self.train_indices)

    @property
    def num_eval(self) -> int:
        return len(self.scene.eval_indices)

    def _load(self, idx: int) -> Dict:
        if idx in self._cache:
            return self._cache[idx]
        frame: Frame = self.scene.frames[idx]
        d = self.cfg.downscale_factor or 1
        image = load_image_uint8(frame.image_path, downscale=d)
        cam = frame.camera.rescaled(1.0 / d) if d > 1 else frame.camera
        # undistort at cache time: the render path assumes an ideal pinhole
        dist = cam.distortion
        if dist is not None:
            image = undistort_image(image, cam.intrinsics_matrix(), dist,
                                    camera_model=cam.camera_model)
            cam = dataclasses.replace(cam, distortion=None)
        item: Dict = {"image": image, "camera": cam, "cam_idx": idx}
        if frame.depth_path is not None:
            depth = load_depth(frame.depth_path) * self.depth_scale
            depth[~np.isfinite(depth)] = 0.0
            if depth.shape[:2] != image.shape[:2]:
                depth = _resize_nearest(depth, image.shape[0], image.shape[1])
            if dist is not None:
                depth = undistort_image(
                    depth, cam.intrinsics_matrix(), dist, nearest=True,
                    camera_model=cam.camera_model,
                )
            item["depth_image"] = depth[..., None].astype(np.float32)
        if frame.mask_path is not None:
            m = png.to_luma(read_image(frame.mask_path)).astype(np.float32)
            if m.shape[:2] != image.shape[:2]:
                m = _resize_nearest(m, image.shape[0], image.shape[1])
            if dist is not None:
                m = undistort_image(
                    m, cam.intrinsics_matrix(), dist, nearest=True,
                    camera_model=cam.camera_model,
                )
            item["mask"] = (m[..., None] > 127).astype(np.float32)
        self._cache[idx] = item
        return item

    def _next_index(self) -> int:
        if not self._perm:
            self._perm = list(self.rng.permutation(self.train_indices))
        return int(self._perm.pop())

    def next_train(self, step: int) -> Dict:
        return self._load(self._next_index())

    def next_train_batch(self, step: int, n: int,
                         keep: Optional[slice] = None) -> List[Dict]:
        """``n`` draws of :meth:`next_train` (the cameras of one
        view-parallel step); only those in ``keep`` (a slice of the ``n``,
        default all) are loaded and returned. Every caller with the same
        seed draws the same cameras in the same order."""
        ids = [self._next_index() for _ in range(n)]
        return [self._load(i) for i in ids[keep or slice(None)]]

    def eval_items(self):
        for idx in self.scene.eval_indices:
            yield self._load(int(idx))

    def get_item(self, idx: int) -> Dict:
        return self._load(int(idx))
