"""Reading a ``torch.profiler`` trace of part of the window.

The harness exports the profiler's Chrome trace and reads it here:
device intervals (kernels, copies, sets) give the busy time and the
kernel times by name; the host's CUDA runtime calls give the launches;
each idle gap of the device is named by what the host was doing at its
middle (the innermost runtime call, else the innermost operator or range).
With the program's tracing on, the step's stage marks and the program's
host ranges are read too (:func:`splatbench.stages.stages_of`): device
seconds by stage, under the program's own stage names, host seconds by
range, and the device's idle seconds inside the trainer's host work
between chunks.
"""

from __future__ import annotations

import heapq
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver"}
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")
SMALL_GAP_US = 10.0
# an empty kernel of the program's tracing: a launch of its own is the
# tracing's, not the program's (inside the step's graph it has none)
MARK = re.compile(r"\bstage_mark<(\d+)>")


def _spans(events, cats):
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e:
            ts = float(e["ts"])
            out.append((ts, ts + float(e["dur"]), e.get("name", "?")))
    out.sort()
    return out


def _innermost(spans: List[Tuple[float, float, str]],
               points: List[float]) -> List[Optional[str]]:
    """For each of ``points``, the name of the shortest span of ``spans``
    (sorted by start) that covers it (of equal ones, the latest to start),
    or None; every span that started before the point is searched."""
    out: List[Optional[str]] = [None] * len(points)
    live: list = []     # (end, start, name) of the spans started so far
    i = 0
    for q in sorted(range(len(points)), key=points.__getitem__):
        t = points[q]
        while i < len(spans) and spans[i][0] <= t:
            s, e, name = spans[i]
            heapq.heappush(live, (e, s, name))
            i += 1
        while live and live[0][0] < t:
            heapq.heappop(live)
        if live:
            out[q] = min(live, key=lambda x: (x[0] - x[1], -x[1]))[2]
    return out


def _mark_launches(events) -> int:
    """The host's kernel launches (not graph launches) of the program's
    stage-mark kernels, matched by the profiler's correlation id."""
    ids = {e.get("args", {}).get("correlation") for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and MARK.search(e.get("name", ""))}
    ids.discard(None)
    return sum(1 for e in events
               if e.get("ph") == "X" and e.get("cat") in HOST_CATS
               and e.get("name", "").startswith(LAUNCHES)
               and not e["name"].startswith("cudaGraphLaunch")
               and e.get("args", {}).get("correlation") in ids)


def read_trace(path: Path, table: Optional[Sequence[str]] = None) -> dict:
    """busy_s, window_s, launches (the stage marks' own left out), kernel
    seconds by name, the top device ops and the longest idle gaps by what
    the host was doing; and :func:`splatbench.stages.stages_of`'s
    ``stages``, ``host_spans`` and ``chunk_host_idle_s`` (stage names
    from ``table``, by default the program's)."""
    from splatbench import stages

    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", events)
    st = stages.stages_of(events, table)
    extra = {"stages": st["stages"], "host_spans": st["host_spans"],
             "chunk_host_idle_s": st["host_spans"]["chunk_host_idle_s"]}
    dev = _spans(events, DEVICE_CATS)
    host_rt = _spans(events, HOST_CATS)
    host_ops = _spans(events, {"cpu_op", "user_annotation",
                               "python_function"})
    all_spans = dev + host_rt + host_ops
    if not dev or not all_spans:
        return {"busy_s": 0.0, "window_s": 0.0, "launches": 0,
                "kernels": {}, "device_ops": [], "idle_gaps": [], **extra}
    lo = min(s for s, _, _ in all_spans)
    hi = max(e for _, e, _ in all_spans)
    kernels: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        kernels[name] += (e - s) * 1e-6
    # union of the device intervals and the gaps between them
    busy, gaps = 0.0, []
    cur_s, cur_e = lo, lo
    for s, e, _ in dev:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    named: Dict[str, float] = defaultdict(float)
    wide = [(a, b) for a, b in gaps if b - a >= SMALL_GAP_US]
    for a, b in gaps:
        if b - a < SMALL_GAP_US:
            named["_gaps_under_10_us_"] += (b - a) * 1e-6
    mids = [0.5 * (a + b) for a, b in wide]
    for (a, b), rt, op in zip(wide, _innermost(host_rt, mids),
                              _innermost(host_ops, mids)):
        named[rt or op or "_no_host_span_"] += (b - a) * 1e-6
    launches = (sum(1 for _, _, n in host_rt if n.startswith(LAUNCHES))
                - _mark_launches(events))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "launches": launches, "kernels": dict(kernels),
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in gaps_top], **extra}
