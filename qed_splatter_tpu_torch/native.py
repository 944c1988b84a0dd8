"""The host core (``csrc/qedcore.cpp``), built and bound with ctypes (port
of ``native.py``).

Three entry points back the host-side pieces the reference delegated to
Open3D: voxel downsampling (the init-pointcloud tool), nearest-neighbour
distances (the point-cloud metrics) and depth backprojection. Two more
decode images where the reference calls PIL: :func:`png_unfilter` undoes
the five PNG row filters, and :func:`jpeg_decode` decodes baseline JPEG as
libjpeg does by default (the pixels PIL returns).

The library is compiled at first use with
``g++ -O3 -fPIC -shared -std=c++17 -pthread`` (no ``-march=native``: the
build may be loaded on another host than the one that made it) into
``csrc/build/``, under a name keyed by a hash of the source and the flags,
and moved into place with ``os.replace``, so processes that build at once
never load half a file. There is no fallback: when ``g++`` is missing or the
build or the load fails, the call raises and names the command and its
output. The plain versions (``ops/voxel.py``, ``ops/knn.py::nn_distances``,
``ops/backproject.py``, ``data/png.py``'s row loops) are what the tests hold
the core against; they are not substituted for it.

Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "qedcore.cpp"
BUILD_DIR = CSRC / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_LIB: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The host core could not be compiled or loaded."""


def lib_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libqedcore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless this source and these flags are built;
    returns the library's path."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: the host geometry core "
            f"({SOURCE}) is compiled at first use and has no fallback")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"building the host geometry core failed (rc {proc.returncode})"
            f": {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded core, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(
            f"loading the host geometry core {path} failed: {e}") from e
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.qed_voxel_downsample.restype = ctypes.c_int64
    lib.qed_voxel_downsample.argtypes = [
        f32p, f32p, ctypes.c_int64, ctypes.c_float, f32p, f32p]
    lib.qed_nn_distances.restype = None
    lib.qed_nn_distances.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_float, f32p]
    lib.qed_backproject.restype = None
    lib.qed_backproject.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, f32p, f32p, ctypes.c_float,
        ctypes.c_int64, f32p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.qed_png_unfilter.restype = i64
    lib.qed_png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
    for name in ("qed_jpeg_info", "qed_jpeg_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, i64,
                       ctypes.POINTER(i64) if name == "qed_jpeg_info"
                       else u8p, ctypes.c_char_p, i64]
    _LIB = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _points(a, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name} must be [N, 3], got {a.shape}")
    return a


def voxel_downsample_native(
    positions: np.ndarray, voxel_size: float,
    colors: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and colors) per voxel of ``floor(p * (1 / voxel))``;
    cells in the core's hash order. Colors come back in their own dtype."""
    lib = load()
    pos = _points(positions, "positions")
    n = len(pos)
    col = _points(colors, "colors") if colors is not None else None
    if col is not None and len(col) != n:
        raise ValueError("colors and positions differ in length")
    out_p = np.empty_like(pos)
    out_c = np.empty((n, 3), np.float32) if col is not None else None
    m = lib.qed_voxel_downsample(
        _fp(pos), _fp(col) if col is not None else None, n,
        ctypes.c_float(voxel_size), _fp(out_p),
        _fp(out_c) if out_c is not None else None)
    out_colors = out_c[:m].astype(colors.dtype) if col is not None else None
    return out_p[:m], out_colors


def nn_distances_native(queries: np.ndarray, refs: np.ndarray,
                        cell_size: float = 0.0) -> np.ndarray:
    """Exact distance from each query to its nearest ref ([Q] float32; inf
    when there is no ref), by a grid hash with expanding rings."""
    lib = load()
    q = _points(queries, "queries")
    r = _points(refs, "refs")
    out = np.empty((len(q),), np.float32)
    lib.qed_nn_distances(_fp(q), len(q), _fp(r), len(r),
                         ctypes.c_float(cell_size), _fp(out))
    return out


def backproject_native(depth: np.ndarray, K: np.ndarray,
                       c2w_cv: np.ndarray, depth_max: float,
                       stride: int = 1) -> np.ndarray:
    """World points [ceil(H/stride) * ceil(W/stride), 3] of a depth map
    (OpenCV camera-to-world ``c2w_cv``), NaN rows for invalid pixels."""
    lib = load()
    d = np.ascontiguousarray(depth, dtype=np.float32)
    Kc = np.ascontiguousarray(K, dtype=np.float32)
    c = np.ascontiguousarray(c2w_cv, dtype=np.float32)
    if d.ndim != 2 or Kc.shape != (3, 3) or c.shape != (4, 4):
        raise ValueError(f"depth [H, W], K [3, 3] and c2w [4, 4] expected, "
                         f"got {d.shape}, {Kc.shape}, {c.shape}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    h, w = d.shape
    out = np.empty((-(-h // stride) * -(-w // stride), 3), np.float32)
    lib.qed_backproject(_fp(d), h, w, _fp(Kc), _fp(c),
                        ctypes.c_float(depth_max), stride, _fp(out))
    return out


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def png_unfilter(data: np.ndarray, height: int, stride: int,
                 bpp: int) -> Tuple[np.ndarray, int]:
    """Undo the PNG filters of ``height`` scanlines (``stride`` bytes after
    each row's filter byte): ([height, stride] uint8, -1), or the index of
    the first row whose filter byte is unknown in place of -1."""
    lib = load()
    d = np.ascontiguousarray(data, dtype=np.uint8)
    if d.size != height * (stride + 1):
        raise ValueError(f"{d.size} bytes for {height} rows of {stride}")
    out = np.empty((height, stride), np.uint8)
    bad = lib.qed_png_unfilter(_u8p(d), height, stride, bpp, _u8p(out))
    return out, int(bad)


class JpegDecodeError(ValueError):
    """A JPEG the core does not decode (the message names the feature)."""


def jpeg_decode(data: bytes) -> np.ndarray:
    """A baseline JPEG's samples as libjpeg's default decompression gives
    them: [H, W] uint8 for gray, [H, W, 3] RGB otherwise. Raises
    :class:`JpegDecodeError` for what the core refuses (progressive,
    arithmetic, 12-bit, lossless, CMYK/YCCK, sampling factors above 2)."""
    lib = load()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int64 * 3)()
    if lib.qed_jpeg_info(data, len(data), info, err, len(err)):
        raise JpegDecodeError(err.value.decode())
    w, h, ch = info
    out = np.empty((h, w) if ch == 1 else (h, w, 3), np.uint8)
    if lib.qed_jpeg_decode(data, len(data), _u8p(out), err, len(err)):
        raise JpegDecodeError(err.value.decode())
    return out
