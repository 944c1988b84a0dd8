"""Tracing of the training path: stage marks on the device, host spans on
the profiler's clock, and the counters read at a chunk's boundaries.

Off by default; :func:`enable` turns it on for the process, :func:`on`
for a block (the trainer's ``train`` when ``TrainerConfig.profile_dir`` is
set). Off, :func:`span` returns
one shared no-op context and :func:`stage` / :func:`stage_outputs` add no
op, no autograd node and no launch, so a CUDA graph captured with tracing
off is the graph of a build without this module.

- **Stage marks.** A CUDA graph of the step (``engine/scan_runner.py``)
  replays bare kernels: the profiler sees no operator or range around
  them. :func:`stage` launches an empty kernel, ``stage_mark<i>``
  (``csrc/stage_mark.cu``), on the current stream where stage
  ``STAGES[i]`` begins; a capture records it, so every replay runs it.
  :func:`stage_outputs` passes a stage's differentiable outputs through an
  identity whose backward launches the ``bwd.`` mark when their gradient
  arrives. Marks fire only inside the step's body (methods decorated with
  :func:`step_body`, on the thread that runs them): eval renders and the
  viewer launch none. The step reads the switch when it runs, so a graph
  holds the marks iff tracing was on at its capture. On the CPU a mark is
  an empty ``record_function`` range named ``qed.stage.<stage>``.
- **Host spans.** :func:`span` is a ``record_function`` range: a
  ``user_annotation`` event on the profiler's clock, whose scalar
  arguments (the chunk's first step, its counters) the Chrome trace holds
  under ``Concrete Inputs`` when the profiler records shapes.
- **Counters.** :data:`COUNTS` (the graph captures made with tracing on,
  process-wide; each runner keeps its own captures and replays) and, on
  CUDA, the allocator's device allocations and retries: :func:`counters`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, Optional

import torch

# the stages of one training step in the order their marks fire: the
# forward, the backward (the autograd engine reaches each stage's outputs
# in the reverse order), then the step's tail. A mark opens its stage; the
# next mark closes it. The bilateral grid's two stages come last, so that a
# step without the grid marks the indices it marked before they were added;
# with the grid on, ``render.bilagrid`` fires after ``render.composite``
# and ``bwd.render.bilagrid`` between ``bwd.loss.ssim`` and
# ``bwd.render.composite``. The grid's total variation stays in
# ``loss.other`` and its Adam in ``step.optimizer``.
STAGES = (
    "step.inputs",          # the scan body's frame select, u8 -> float
    "render.project",       # camera opt, viewmat, projection, radii mask
    "render.sh",            # SH coefficients and colours, opacity, channels
    "render.bin",           # ops/tiles.py::bin_gaussians, both sorts
    "render.composite",     # rank gather, compositing, background, depth
    "loss.ssim",            # the photometric loss: SSIM and its L1 term
    "loss.other",           # depth L1, scale and camera regularizers, sum
    "bwd.loss.other",
    "bwd.loss.ssim",
    "bwd.render.composite",
    "bwd.render.sh",
    "bwd.render.project",
    "step.stats",           # accumulate_stats_
    "step.optimizer",       # gradient hygiene, clip, every group's Adam
    "step.metrics",         # the metrics, their stack and index_copy_
    "step.end",
    "render.bilagrid",      # the camera's grid sliced and applied, clamped
    "bwd.render.bilagrid",
)
INDEX = {name: i for i, name in enumerate(STAGES)}
MAX_STAGES = 32             # csrc/stage_mark.cu's kMaxStages
assert len(STAGES) <= MAX_STAGES

# process-wide counts with tracing on (engine/scan_runner.py adds to them)
COUNTS: Dict[str, int] = {"graph_captures": 0}

_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()      # .device: the step body's, on this thread
_kernel = None


def enable(on: bool = True) -> None:
    """Turn tracing on (or off) for the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def on(turn_on: bool = True):
    """Tracing on inside the block where ``turn_on``; as it was after."""
    was = _on
    enable(was or turn_on)
    try:
        yield
    finally:
        enable(was)


class _Span:
    __slots__ = ("name", "args", "handle")

    def __init__(self, name, args):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch._C._autograd._record_function_with_args_enter(
            self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch._C._autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, *args):
    """A ``record_function`` range ``name`` with scalar ``args`` (ints,
    floats); the shared no-op context when tracing is off."""
    return _Span(name, args) if _on else _NULL


def step_body(method):
    """Decorates a method of an object with a ``device`` that runs (part
    of) the training step: :func:`stage` marks fire inside it."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        if not _on:
            return method(self, *args, **kwargs)
        prev = getattr(_local, "device", None)
        _local.device = self.device
        try:
            return method(self, *args, **kwargs)
        finally:
            _local.device = prev
    return wrapped


def _mark(index: int, device: torch.device) -> None:
    global _kernel
    if device.type != "cuda":
        with torch.profiler.record_function("qed.stage." + STAGES[index]):
            pass
        return
    if _kernel is None:
        from qed_splatter_tpu_torch.cuda import CudaKernel

        _kernel = CudaKernel("stage_mark", "qed_stage_mark", [ctypes.c_int])
    _kernel(index)


def _device() -> Optional[torch.device]:
    return getattr(_local, "device", None) if _on else None


def stage(name: str) -> None:
    """Mark where stage ``name`` begins on the device (inside the step's
    body, with tracing on; else nothing)."""
    dev = _device()
    if dev is not None:
        _mark(INDEX[name], dev)


class _BackwardMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, index, device, *xs):
        ctx.index, ctx.device = index, device
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _mark(ctx.index, ctx.device)
        return (None, None, *grads)


def stage_outputs(name: str, *tensors):
    """``tensors`` (a tuple), those that need a gradient passed through an
    identity whose backward marks ``bwd.<name>`` when their gradients have
    arrived; unchanged outside the step's body or with tracing off."""
    dev = _device()
    live = [t is not None and t.requires_grad for t in tensors]
    if dev is None or not any(live):
        return tensors
    marked = iter(_BackwardMark.apply(
        INDEX["bwd." + name], dev,
        *(t for t, on in zip(tensors, live) if on)))
    return tuple(next(marked) if on else t for t, on in zip(tensors, live))


def counters(device) -> Dict[str, int]:
    """:data:`COUNTS` now, with the caching allocator's ``device_allocs``
    and ``alloc_retries`` (``num_device_alloc``, ``num_alloc_retries``) on
    a CUDA device."""
    out = dict(COUNTS)
    dev = torch.device(device)
    if dev.type == "cuda":
        st = torch.cuda.memory_stats(dev)
        out["device_allocs"] = int(st.get("num_device_alloc", 0))
        out["alloc_retries"] = int(st.get("num_alloc_retries", 0))
    return out
