"""nerfstudio camera-path JSON (port of ``data/camera_path.py``).

The JSON that nerfstudio's camera-path editor saves and ``ns-render
camera-path`` reads: a ``camera_path`` list of frames, each with a row-major
``camera_to_world`` (OpenGL convention, as in transforms.json; 16 or 12
elements, flat or nested) and a vertical ``fov`` in degrees, plus
``render_width`` / ``render_height``. Parsed into the (c2w, K, width, height)
tuples the render CLI consumes.
"""

from __future__ import annotations

import json
import math
from typing import List, Tuple

import numpy as np


def _parse_c2w(val) -> np.ndarray:
    m = np.asarray(val, np.float32).reshape(-1)
    if m.size == 16:
        return m.reshape(4, 4)[:3, :4]
    if m.size == 12:
        return m.reshape(3, 4)
    raise ValueError(
        f"camera_to_world must have 12 or 16 elements, got {m.size}"
    )


def load_camera_path(
    path: str,
    default_width: int = 1920,
    default_height: int = 1080,
) -> List[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Parse a nerfstudio camera-path JSON -> [(c2w[3,4], K[3,3], w, h)].

    ``fov`` is the full *vertical* field of view in degrees (nerfstudio's
    camera-path convention): fx = fy = h / (2 tan(fov/2)).
    """
    with open(path) as f:
        data = json.load(f)
    frames = data.get("camera_path")
    if frames is None:
        raise ValueError(
            f"{path}: no 'camera_path' key — not a nerfstudio camera path"
        )
    width = int(data.get("render_width", default_width))
    height = int(data.get("render_height", default_height))
    default_fov = float(data.get("fov", 50.0))
    cams = []
    for fr in frames:
        c2w = _parse_c2w(fr["camera_to_world"])
        fov = float(fr.get("fov", default_fov))
        fy = height / (2.0 * math.tan(math.radians(fov) / 2.0))
        # nerfstudio keyframes carry aspect but render at the path's
        # width/height with square pixels; fx = fy
        K = np.array(
            [[fy, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]],
            np.float32,
        )
        cams.append((c2w, K, width, height))
    return cams
