"""The step split by stage, and the program's host spans, from a Chrome
trace of a run with the program's tracing on.

With ``qed_splatter_tpu_torch.tracing`` enabled before the step's graph is
captured, every replayed step launches an empty kernel, ``stage_mark<i>``,
where stage ``tracing.STAGES[i]`` begins, and the trainer wraps its chunks
and the host work between them in ``qed.`` ranges (``user_annotation``
events). :func:`stages_of` reads both:

- ``stages``: device busy seconds by stage. The busy time between one mark
  and the next on the marks' stream goes to the stage the earlier mark
  opened; time after ``step.end`` (between steps) and outside the marks
  goes to no stage. Empty where the program has no table or the trace no
  mark (tracing off, or a program without it).
- ``host_spans``: host seconds by ``qed.`` range name, and
  ``chunk_host_idle_s``: the device's idle seconds (gaps of the union of
  all device intervals, as :func:`splatbench.trace.read_trace` takes them)
  that fall inside ``qed.chunk.host`` ranges.

:func:`splatbench.trace.read_trace` merges both into the run's trace, so a
per-layer metric reads a stage by its name in the program's table,
``run.trace["stages"][name]``: a stage the program adds is read by a new
metric file alone. :data:`LAYER_MS` turns them into the per-layer numbers
the stage marks measure, in ms a traced step (or a traced chunk), and
:func:`layer_ms` reads one of them from a run;
:func:`busy_in_steps_s` is the busy time the stages should cover,
:func:`launches_by_span` the host's launches by the innermost ``qed.``
range around them. Run as a script, one traced run of a cell:

    python3 -m splatbench.stages --workload <name> --seed <n> \
        [--seconds 51]

prints one JSON line: the step split by stage, the host spans, the layer
numbers and the launches a step by span, beside the run's per-layer
metrics.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from splatbench.trace import DEVICE_CATS, HOST_CATS, LAUNCHES, MARK

HOST_SPAN_CATS = {"user_annotation"}
# the categories whose extent is the trace's window in read_trace
WINDOW_CATS = DEVICE_CATS | HOST_CATS | {"cpu_op", "user_annotation",
                                         "python_function"}


def program_stages() -> Optional[Sequence[str]]:
    """The program's table of stage names by mark index, or None."""
    try:
        from qed_splatter_tpu_torch import tracing
    except ImportError:
        return None
    return getattr(tracing, "STAGES", None)


def _union(intervals: List[Tuple[float, float]]):
    """Sorted, merged copy of ``intervals``."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, a: float, b: float) -> float:
    """Length of [a, b] covered by the merged intervals."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged
               if s < b and e > a)


def _stage_seconds(events, table) -> Dict[str, float]:
    marks = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                and "dur" in e):
            m = MARK.search(e.get("name", ""))
            if m:
                marks.append((float(e["ts"]), int(m.group(1)),
                              (e.get("pid"), e.get("tid"))))
    if not table or not marks:
        return {}
    marks.sort()
    streams = {m[2] for m in marks}
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                   and "dur" in e
                   and (e.get("pid"), e.get("tid")) in streams])
    out: Dict[str, float] = defaultdict(float)
    for (a, i, _), (b, _, _) in zip(marks, marks[1:]):
        name = table[i] if i < len(table) else f"stage_{i}"
        if name != "step.end":
            out[name] += _overlap(busy, a, b) * 1e-6
    return dict(out)


def stages_of(events: list, table: Optional[Sequence[str]] = None) -> dict:
    """``{"stages": {...}, "host_spans": {..., "chunk_host_idle_s"}}`` of
    a Chrome trace's events; ``table`` defaults to the program's."""
    table = program_stages() if table is None else table
    spans: Dict[str, float] = defaultdict(float)
    host = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in HOST_SPAN_CATS
                and "dur" in e and e.get("name", "").startswith("qed.")):
            spans[e["name"]] += float(e["dur"]) * 1e-6
            if e["name"] == "qed.chunk.host":
                ts = float(e["ts"])
                host.append((ts, ts + float(e["dur"])))
    # the device's idle gaps over the trace's extent, as read_trace takes
    # them
    dev, every = [], []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in WINDOW_CATS
                and "dur" in e):
            iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            every.append(iv)
            if e.get("cat") in DEVICE_CATS:
                dev.append(iv)
    idle = 0.0
    if dev:
        lo = min(s for s, _ in every)
        hi = max(e for _, e in every)
        merged = _union(dev)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        host_merged = _union(host)
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                idle += _overlap(host_merged, a, b)
    host_spans = dict(spans)
    host_spans["chunk_host_idle_s"] = idle * 1e-6
    return {"stages": _stage_seconds(events, table),
            "host_spans": host_spans}


def _stage_ms(*names):
    def read(st: dict, steps: int, chunks: int) -> Optional[float]:
        got = [v for k, v in st["stages"].items()
               if k in names or (k.startswith("bwd.") and k[4:] in names)]
        if not got or steps <= 0:
            return None
        return 1e3 * sum(got) / steps
    return read


def _chunk_host_idle_ms(st: dict, steps: int, chunks: int):
    if "qed.chunk.host" not in st["host_spans"] or chunks <= 0:
        return None
    return 1e3 * st["host_spans"]["chunk_host_idle_s"] / chunks


# per-layer numbers from stages_of(): ms a traced step, forward and
# backward where the stage has both (the last: ms a traced chunk)
LAYER_MS = {
    "binning_ms": _stage_ms("render.bin"),
    "render_rows_ms": _stage_ms("render.project", "render.sh"),
    "ssim_ms": _stage_ms("loss.ssim"),
    "optimizer_ms": _stage_ms("step.optimizer"),
    "chunk_host_idle_ms": _chunk_host_idle_ms,
}


def layer_ms(name: str, run) -> Optional[float]:
    """``LAYER_MS[name]`` of a run's trace (None without one)."""
    t = getattr(run, "trace", None)
    if not t or "stages" not in t or not t.get("traced_steps"):
        return None
    return LAYER_MS[name](t, int(t["traced_steps"]),
                          int(t.get("traced_chunks", 0)))


def _events(path: Path) -> list:
    events = json.loads(Path(path).read_text())
    return events.get("traceEvents", events)


def busy_in_steps_s(events, table) -> float:
    """Device busy seconds (every stream) from each ``step.inputs`` mark to
    the ``step.end`` mark after it: what the stages should cover."""
    dev, marks = [], []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e:
            ts = float(e["ts"])
            dev.append((ts, ts + float(e["dur"])))
            m = MARK.search(e.get("name", ""))
            if m and int(m.group(1)) < len(table):
                marks.append((ts, table[int(m.group(1))]))
    merged = _union(dev)
    inside, opened = 0.0, None
    for ts, name in sorted(marks):
        if name == "step.inputs":
            opened = ts
        elif name == "step.end" and opened is not None:
            inside += _overlap(merged, opened, ts)
            opened = None
    return inside * 1e-6


def launches_by_span(events, steps: int) -> Dict[str, float]:
    """The host's launch calls (``trace.LAUNCHES``) a step by the innermost
    ``qed.`` range around each (``_no_span_`` outside them)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_SPAN_CATS
                   and "dur" in e and e.get("name", "").startswith("qed."))
    starts = [a for a, _, _ in spans]
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in HOST_CATS
                and e.get("name", "").startswith(LAUNCHES)):
            t = float(e["ts"])
            best = None
            for a, b, name in reversed(spans[:bisect.bisect_right(starts, t)]):
                if b >= t and (best is None or b - a < best[0]):
                    best = (b - a, name)
            out[best[1] if best else "_no_span_"] += 1.0 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def split(path: Path, trace: dict, chunks: int,
          table: Optional[Sequence[str]] = None) -> dict:
    """The traced stretch at ``path`` by stage and span, per traced step
    (``trace`` is ``read_trace``'s dict with ``traced_steps``)."""
    table = program_stages() if table is None else table
    steps = int(trace["traced_steps"])
    events = _events(path)
    st = stages_of(events, table)
    busy = trace["busy_s"]
    idle = trace["window_s"] - busy
    inside = busy_in_steps_s(events, table or ())
    stage_sum = sum(st["stages"].values())
    return {
        "traced_steps": steps, "busy_ms_step": 1e3 * busy / steps,
        "window_ms_step": 1e3 * trace["window_s"] / steps,
        "busy_in_steps_ms_step": 1e3 * inside / steps,
        "stage_sum_ms_step": 1e3 * stage_sum / steps,
        "stage_cover": stage_sum / inside if inside > 0 else None,
        "stage_ms_step": {k: 1e3 * v / steps for k, v in sorted(
            st["stages"].items(), key=lambda kv: -kv[1])},
        "host_span_ms_chunk": {k: 1e3 * v / chunks for k, v in sorted(
            st["host_spans"].items(), key=lambda kv: -kv[1])},
        "layer_ms": {k: f(st, steps, chunks) for k, f in LAYER_MS.items()},
        "no_host_span_share": (dict(trace["idle_gaps"]).get(
            "_no_host_span_", 0.0) / idle if idle > 0 else None),
        "launches_step_by_span": launches_by_span(events, steps)}


def main(argv=None) -> int:
    import argparse
    import shutil

    from splatbench import run as brun

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args(argv)
    brun._environment()
    from splatbench import harness, spec

    cell = spec.load_cell(args.workload)
    out = harness.run_cell(cell, args.seed, args.seconds, True)
    try:
        run = out["run"]
        res = {"workload": args.workload, "seed": args.seed,
               "correct": bool(out["checks"]["correct"]),
               "card": brun._power_limit(),
               "per_layer": spec.read_metrics(cell.per_layer, run),
               "idle_gaps": run.trace["idle_gaps"],
               **split(out["work"] / "trace.json", run.trace,
                       int(cell.traffic["trace_chunks"]))}
    finally:
        shutil.rmtree(out["work"], ignore_errors=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
