"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on first use into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under ``csrc/build/`` by a hash of the source, the headers
it may include (``csrc/*.cuh`` and those beside the source) and the flags,
and loaded with ``ctypes``. Every C entry point takes device pointers, sizes
and a ``cudaStream_t`` and returns ``cudaGetLastError()``; :class:`CudaKernel`
raises when that is non-zero and counts successful launches.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
# -fmad=false: the kernels evaluate alpha with the same op-by-op rounding as
# their plain PyTorch versions, so the discontinuous alpha masks agree
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# every CudaKernel made, so a CUDA graph's replays can add the launches its
# capture recorded (engine/scan_runner.py)
KERNELS: List["CudaKernel"] = []
# nvcc's output (-Xptxas -v) by source name, followed by the defines if any
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    # a header beside the source is found first, then those of csrc/ (-I)
    for d in dict.fromkeys((src.parent, CSRC)):
        for header in sorted(d.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return BUILD_DIR / f"lib{Path(name).name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str], defines: Sequence[str] = ()) -> float:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. A name is a path under ``csrc/`` without
    ``.cu``. ``defines`` (``-DNAME=value`` flags) select a tuning variant of
    a source. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name in names:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[" ".join((name, *defines))] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    path = _lib_path(name, defines)
    if str(path) not in _LIBS:
        if not path.exists():
            build([name], defines)
        _LIBS[str(path)] = ctypes.CDLL(str(path))
    return _LIBS[str(path)]


class CudaKernel:
    """One C entry point of one ``csrc`` source, with a launch count.

    ``argtypes`` lists ctypes types for the arguments before the trailing
    stream (``c_void_p`` for every pointer, ``c_int``/``c_float`` for
    scalars); the stream is appended from ``torch.cuda.current_stream()``.
    ``defines`` builds a tuning variant of the source (see :func:`build`).
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 defines: Sequence[str] = ()):
        self.source = source
        self.symbol = symbol
        self.defines = tuple(defines)
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        # launches by named code path inside the kernel (e.g. "chunked")
        self.variant_launches: Dict[str, int] = {}
        self._fn = None
        KERNELS.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.variant_launches = {}

    def add(self, launches: int, variants: Dict[str, int]) -> None:
        """Count launches made without a host call: the replays of a CUDA
        graph whose capture called this kernel (negative to take back the
        capture's own calls, which launched nothing)."""
        self.launches += launches
        for k, n in variants.items():
            self.variant_launches[k] = self.variant_launches.get(k, 0) + n

    def __call__(self, *args, variant: str = "") -> None:
        if self._fn is None:
            fn = getattr(_lib(self.source, self.defines), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: cudaError {rc}")
        self.launches += 1
        if variant:
            self.variant_launches[variant] = (
                self.variant_launches.get(variant, 0) + 1)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
