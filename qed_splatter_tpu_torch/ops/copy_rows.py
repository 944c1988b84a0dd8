"""Identity copy of an ``[M, C]`` float32 array through the hand-written
kernel ``csrc/copy_rows.cu``.

The port of ``tools/bench_gather3.py::pallas_copy``, the JAX
microbenchmark's Pallas copy that pinned an array to row-major layout around
a gather. CUDA tensors launch the kernel; CPU tensors take the plain version,
:func:`copy_rows_ref`. :func:`copy_plan` splits the flat copy into the
kernel's head, 16-byte aligned body and tail, and picks the body's form.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from qed_splatter_tpu_torch.cuda import CudaKernel, ptr

COPY_ROWS = CudaKernel("copy_rows", "qed_copy_rows",
                       [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3)


class CopyPlan(NamedTuple):
    """How the kernel copies ``head + body + tail`` floats: ``head`` floats
    one at a time up to the first 16-byte boundary, ``body`` floats (whole
    16-byte vectors, aligned in both arrays) in the form ``path``, ``tail``
    floats one at a time. ``path`` is "bulk", "scalar" (everything one
    float at a time: the head) or "none" (an empty copy)."""

    path: str
    head: int
    body: int
    tail: int


def copy_plan(src_addr: int, dst_addr: int, n: int) -> CopyPlan:
    """Split a copy of ``n`` floats from byte address ``src_addr`` to
    ``dst_addr`` for the kernel. The two addresses must lie at the same
    distance from a 16-byte boundary for an aligned body, which the kernel
    copies with TMA bulk copies; where they do not, or fewer than four
    floats remain past the head, the whole copy goes one float at a
    time."""
    if n < 0 or src_addr % 4 or dst_addr % 4:
        raise ValueError("a float32 copy of n >= 0 floats at 4-byte aligned "
                         "addresses")
    if n == 0:
        return CopyPlan("none", 0, 0, 0)
    if (src_addr - dst_addr) % 16:
        return CopyPlan("scalar", n, 0, 0)
    head = min(n, (-src_addr) % 16 // 4)
    body = (n - head) // 4 * 4
    if body == 0:
        return CopyPlan("scalar", n, 0, 0)
    return CopyPlan("bulk", head, body, n - head - body)


def copy_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`copy_rows`."""
    return x.clone()


def copy_rows(x: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A contiguous float32 tensor equal to ``x`` (any shape; the
    microbenchmark's are ``[M, C]``): ``out`` when given (contiguous, of
    ``x``'s shape and device), else a new one. The launch is counted under
    its :func:`copy_plan` path."""
    if x.dtype != torch.float32:
        raise TypeError(f"copy_rows takes float32, got {x.dtype}")
    if out is not None and (out.dtype != torch.float32
                            or out.shape != x.shape
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 tensor of x's "
                         "shape and device")
    if x.device.type == "cpu":
        if out is None:
            return copy_rows_ref(x)
        return out.copy_(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    src = x.contiguous()
    if out is None:
        out = torch.empty_like(src)
    plan = copy_plan(src.data_ptr(), out.data_ptr(), src.numel())
    if plan.path == "none":
        return out
    COPY_ROWS(ptr(src), ptr(out), src.numel(), plan.head, plan.body,
              variant=plan.path)
    return out
