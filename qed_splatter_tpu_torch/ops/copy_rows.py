"""Identity copy of an ``[M, C]`` float32 array through the hand-written
kernel ``csrc/copy_rows.cu``.

The port of ``tools/bench_gather3.py::pallas_copy``, the JAX
microbenchmark's Pallas copy that pinned an array to row-major layout around
a gather. CUDA tensors launch the kernel; CPU tensors take the plain version,
:func:`copy_rows_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from qed_splatter_tpu_torch.cuda import CudaKernel, ptr

COPY_ROWS = CudaKernel("copy_rows", "qed_copy_rows",
                       [ctypes.c_void_p] * 2 + [ctypes.c_longlong])


def copy_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`copy_rows`."""
    return x.clone()


def copy_rows(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous float32 tensor equal to ``x`` (any shape; the
    microbenchmark's are ``[M, C]``)."""
    if x.dtype != torch.float32:
        raise TypeError(f"copy_rows takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return copy_rows_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    src = x.contiguous()
    out = torch.empty_like(src)
    COPY_ROWS(ptr(src), ptr(out), src.numel())
    return out
