"""Device time of one operation on the GPU (port of
``utils/microbench.py``).

:func:`device_time_per_call` captures ``n`` calls of the operation in a CUDA
graph and times the graph's replays with CUDA events, so the host's cost of
launching (which exceeds a kernel of a few microseconds) is not in the
number; every call's result is kept until the end, so each writes a buffer
of its own and no output stays in L2 for the next. Where an operation cannot
be captured (it synchronizes with the host, or allocates outside the
graph's pool) it times ``n`` eager calls between two CUDA events instead,
and says so.

The JAX version's ``perturb`` argument has no counterpart: it made each
call's input depend on the previous output so that XLA would not hoist or
merge the calls inside one ``fori_loop``. PyTorch runs each call as it is
issued; nothing is hoisted.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# how the last call of device_time_per_call timed: "graph" or "eager"
last_method = ""


def _eager_seconds(op, args, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        op(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def device_time_per_call(op: Callable, args: Sequence = (), n: int = 10,
                         warmup: bool = True, graph: bool = True) -> float:
    """Mean device seconds per ``op(*args)``.

    ``graph=True``: ``n`` calls captured in one CUDA graph, whose replays
    (one to warm up, five timed) are timed; an operation that cannot be
    captured falls to the eager timing. ``graph=False``: ``n`` eager calls
    between two CUDA events, launch cost included. ``warmup`` runs one call
    first (kernel builds, allocator and library set-up)."""
    global last_method
    if warmup:
        op(*args)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                kept = [op(*args) for _ in range(n)]
        except RuntimeError:
            torch.cuda.synchronize()
        else:
            g.replay()
            torch.cuda.synchronize()
            secs = _eager_seconds(g.replay, (), 5) / n
            del kept, g
            last_method = "graph"
            return secs
    last_method = "eager"
    return _eager_seconds(op, args, n)
