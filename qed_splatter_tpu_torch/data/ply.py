"""PLY point-cloud IO in pure numpy (a copy of ``qed_splatter_tpu.data.ply``,
which the port may not import; no Open3D dependency).

Replaces the reference's Open3D PLY paths with the same color semantics the
reference had to special-case (reference dataparser.py:25-74):

- float colors in [0, 1] are converted to uint8 (the Open3D tensor-API
  write format the reference's ``_load_ply_colors`` exists to fix);
- uint8 colors pass through;
- missing colors -> zeros (dataparser.py:74).

Supports ascii and binary_little_endian, reading ``x y z`` positions plus
optional ``red green blue`` / ``r g b`` colors and ``nx ny nz`` normals;
writes binary_little_endian float32 positions + uint8 colors — readable by
Open3D/nerfstudio tooling.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_COLOR_ALIASES = {
    "red": "red", "green": "green", "blue": "blue",
    "r": "red", "g": "green", "b": "blue",
}


class PlyData:
    """Parsed PLY vertex data."""

    def __init__(self, positions: np.ndarray,
                 colors: Optional[np.ndarray] = None,
                 normals: Optional[np.ndarray] = None):
        self.positions = positions  # [N, 3] float32
        self.colors = colors        # [N, 3] uint8 or None
        self.normals = normals      # [N, 3] float32 or None

    def __len__(self) -> int:
        return len(self.positions)

    def colors_uint8(self) -> np.ndarray:
        """Colors as uint8, zeros when absent (reference dataparser.py:58-74)."""
        if self.colors is None:
            return np.zeros((len(self), 3), dtype=np.uint8)
        return self.colors


def read_ply(path) -> PlyData:
    raw = Path(path).read_bytes()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"Not a PLY file (no end_header): {path}")
    header = raw[:header_end].decode("ascii", errors="replace").splitlines()
    body = raw[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"Not a PLY file (missing magic): {path}")

    fmt = None
    elements = []  # list of (name, count, [(prop_name, np dtype str)])
    cur = None
    for line in header[1:]:
        tok = line.strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property":
            if cur is None:
                continue
            if tok[1] == "list":
                cur[2].append((tok[4], ("list", _DTYPES[tok[2]], _DTYPES[tok[3]])))
            else:
                cur[2].append((tok[2], _DTYPES[tok[1]]))
    if fmt is None:
        raise ValueError(f"PLY missing format line: {path}")
    if fmt == "binary_big_endian":
        endian = ">"
    else:
        endian = "<"

    vert = None
    offset = 0
    stream = io.BytesIO(body)
    for name, count, props in elements:
        has_list = any(isinstance(d, tuple) for _, d in props)
        if fmt == "ascii":
            # consume `count` text lines
            text = body.decode("ascii", errors="replace").splitlines()
            rows = text[offset:offset + count]
            offset += count
            if name == "vertex":
                cols = [p for p, _ in props]
                arr = np.loadtxt(
                    io.StringIO("\n".join(rows)), dtype=np.float64, ndmin=2
                )
                vert = {c: arr[:, i] for i, c in enumerate(cols)}
            continue
        if has_list and name != "vertex":
            # skip list-bearing non-vertex elements (faces) conservatively:
            # nothing after them is needed for point clouds
            break
        dtype = np.dtype([(p, endian + d) for p, d in props])
        data = np.frombuffer(
            stream.read(dtype.itemsize * count), dtype=dtype, count=count
        )
        if name == "vertex":
            vert = {p: data[p] for p, _ in props}

    if vert is None or "x" not in vert:
        raise ValueError(f"PLY has no vertex x/y/z data: {path}")

    positions = np.stack(
        [vert["x"], vert["y"], vert["z"]], axis=-1
    ).astype(np.float32)

    colors = _extract_colors(vert)
    normals = None
    if all(k in vert for k in ("nx", "ny", "nz")):
        normals = np.stack(
            [vert["nx"], vert["ny"], vert["nz"]], axis=-1
        ).astype(np.float32)
    return PlyData(positions, colors, normals)


def _extract_colors(vert: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    chans = {}
    for key, canon in _COLOR_ALIASES.items():
        if key in vert and canon not in chans:
            chans[canon] = vert[key]
    if not all(k in chans for k in ("red", "green", "blue")):
        return None
    c = np.stack([chans["red"], chans["green"], chans["blue"]], axis=-1)
    if np.issubdtype(c.dtype, np.floating):
        # float [0,1] -> uint8 (reference dataparser.py:66-67)
        return (np.clip(c, 0.0, 1.0) * 255.0).astype(np.uint8)
    return c.astype(np.uint8)


def write_ply(path, positions: np.ndarray,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Write binary_little_endian PLY: float32 xyz (+uint8 rgb, +float32 n)."""
    positions = np.asarray(positions, dtype=np.float32)
    n = positions.shape[0]
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header_props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        props += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header_props += [
            "property float nx", "property float ny", "property float nz"
        ]
    if colors is not None:
        colors = np.asarray(colors)
        if np.issubdtype(colors.dtype, np.floating):
            colors = (np.clip(colors, 0.0, 1.0) * 255.0).astype(np.uint8)
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header_props += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    rec = np.empty(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = positions[:, 0], positions[:, 1], positions[:, 2]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2]
        )
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + header_props
        + ["end_header", ""]
    )
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
