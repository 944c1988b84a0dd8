"""The stage and host-span reader on a Chrome trace small enough to work by
hand, and the trace reader's older keys held on the same file."""

import json

import pytest

from splatbench import stages
from splatbench.trace import read_trace

TABLE = ("a", "b", "step.end")


def _x(cat, name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def _trace(tmp_path):
    """Two steps on stream 7: marks a, b, step.end (times in us), kernels
    between them, one kernel after step.end, a copy on another stream; the
    host's runtime calls, an operator and the program's ranges, with two
    qed.chunk.host ranges over device gaps of 120 and 3 us."""
    ev = [
        _x("kernel", "void stage_mark<0>()", 100, 1),
        _x("kernel", "elementwise_kernel", 102, 10),
        _x("kernel", "void stage_mark<1>()", 120, 1),
        _x("kernel", "void composite_kernel<4, true>()", 121, 20),
        _x("kernel", "void stage_mark<2>()", 150, 1),
        _x("kernel", "elementwise_kernel", 160, 5),
        _x("gpu_memcpy", "Memcpy HtoD", 162, 2, tid=9),
        _x("kernel", "void stage_mark<0>()", 300, 1),
        _x("kernel", "elementwise_kernel", 301, 9),
        _x("kernel", "void stage_mark<2>()", 320, 1),
        _x("cuda_runtime", "cudaGraphLaunch", 90, 5, tid=1),
        _x("cuda_runtime", "cudaLaunchKernel", 155, 3, tid=1),
        _x("cpu_op", "aten::copy_", 60, 5, tid=1),
        _x("user_annotation", "qed.chunk", 80, 320, tid=1),
        _x("user_annotation", "qed.chunk.host", 170, 120, tid=1),
        _x("user_annotation", "qed.refine", 200, 50, tid=1),
        _x("user_annotation", "qed.chunk.host", 315, 3, tid=1),
        {"ph": "s", "name": "flow", "ts": 90, "id": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_read_trace_keys_unchanged_on_a_trace_with_marks_and_spans(
        tmp_path):
    got = read_trace(_trace(tmp_path))
    assert got["busy_s"] == pytest.approx(49e-6)
    assert got["window_s"] == pytest.approx(340e-6)
    assert got["launches"] == 2
    assert got["kernels"] == pytest.approx({
        "void stage_mark<0>()": 2e-6, "void stage_mark<1>()": 1e-6,
        "void stage_mark<2>()": 2e-6, "elementwise_kernel": 24e-6,
        "void composite_kernel<4, true>()": 20e-6, "Memcpy HtoD": 2e-6})
    assert [n for n, _ in got["device_ops"]] == [
        "elementwise_kernel", "void composite_kernel<4, true>()",
        "void stage_mark<0>()", "void stage_mark<2>()", "Memcpy HtoD",
        "void stage_mark<1>()"]
    assert dict(got["idle_gaps"]) == pytest.approx({
        "qed.refine": 135e-6, "qed.chunk": 119e-6,
        "_gaps_under_10_us_": 27e-6, "qed.chunk.host": 10e-6})


def test_stages_split_the_busy_time_between_marks(tmp_path):
    got = read_trace(_trace(tmp_path), TABLE)
    # a: the mark and a kernel in each step; b: its mark and the
    # compositing; after step.end and on stream 9: no stage
    assert got["stages"] == pytest.approx({"a": 21e-6, "b": 21e-6})
    assert sum(got["stages"].values()) == pytest.approx(42e-6)
    assert got["host_spans"] == pytest.approx({
        "qed.chunk": 320e-6, "qed.chunk.host": 123e-6,
        "qed.refine": 50e-6, "chunk_host_idle_s": 123e-6})
    ms = {k: f(got, 2, 1) for k, f in stages.LAYER_MS.items()}
    assert ms["chunk_host_idle_ms"] == pytest.approx(0.123)
    assert ms["binning_ms"] is None


def test_stages_empty_without_a_table_or_marks(tmp_path):
    path = _trace(tmp_path)
    assert read_trace(path, ())["stages"] == {}
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if "stage_mark" not in e["name"]]
    path.write_text(json.dumps({"traceEvents": ev}))
    got = read_trace(path, TABLE)
    assert got["stages"] == {}
    assert all(f(got, 2, 1) is None for k, f in stages.LAYER_MS.items()
               if k != "chunk_host_idle_ms")


def test_stage_names_come_from_the_program():
    from qed_splatter_tpu_torch import tracing

    assert stages.program_stages() == tracing.STAGES
    for name in ("render.bin", "render.project", "render.sh", "loss.ssim",
                 "bwd.loss.ssim", "step.optimizer"):
        assert name in tracing.STAGES


def test_busy_in_steps_and_the_split_of_a_traced_stretch(tmp_path):
    path = _trace(tmp_path)
    table = ("step.inputs", "b", "step.end")
    events = json.loads(path.read_text())["traceEvents"]
    # step 1 from 100 to 150: 1 + 10 + 21 us busy; step 2, 300-320: 10 us
    assert stages.busy_in_steps_s(events, table) == pytest.approx(42e-6)
    assert stages.busy_in_steps_s(events, ("a", "b", "c")) == 0.0
    trace = dict(read_trace(path), traced_steps=2)
    got = stages.split(path, trace, 1, table)
    assert got["stage_cover"] == pytest.approx(1.0)
    assert got["busy_in_steps_ms_step"] == pytest.approx(0.021)
    assert got["stage_ms_step"] == pytest.approx({"step.inputs": 0.0105,
                                                  "b": 0.0105})
    assert got["layer_ms"]["chunk_host_idle_ms"] == pytest.approx(0.123)
    assert got["launches_step_by_span"] == pytest.approx({"qed.chunk": 1.0})


def test_launches_go_to_the_innermost_program_range():
    ev = [_x("user_annotation", "qed.chunk", 0, 400, tid=1),
          _x("user_annotation", "qed.refine", 200, 50, tid=1),
          _x("user_annotation", "other", 205, 10, tid=1),
          _x("cuda_runtime", "cudaGraphLaunch", 90, 5, tid=1),
          _x("cuda_runtime", "cudaLaunchKernel", 210, 3, tid=1),
          _x("cuda_runtime", "cudaMemcpyAsync", 220, 3, tid=1),
          _x("cuda_runtime", "cudaStreamSynchronize", 230, 3, tid=1),
          _x("cuda_runtime", "cudaLaunchKernel", 500, 3, tid=1)]
    assert stages.launches_by_span(ev, 2) == pytest.approx(
        {"qed.refine": 1.0, "qed.chunk": 0.5, "_no_span_": 0.5})


def test_the_run_trace_reads_a_stage_the_table_adds_by_its_name(tmp_path):
    from splatbench import harness, spec

    # the program's table with a stage it does not have today
    table = ("a", "render.bilagrid", "step.end")
    trace = read_trace(_trace(tmp_path), table)
    assert trace["stages"] == pytest.approx({"a": 21e-6,
                                             "render.bilagrid": 21e-6})
    assert trace["chunk_host_idle_s"] == pytest.approx(123e-6)
    assert trace["host_spans"]["qed.refine"] == pytest.approx(50e-6)
    run = harness.Run()
    run.trace = dict(trace, traced_steps=2, traced_chunks=1)
    # what a metric file added for the new stage would read
    assert 1e3 * run.trace["stages"]["render.bilagrid"] / 2 == \
        pytest.approx(0.0105)
    assert spec.reader("chunk_host_idle_ms.train")(run) == \
        pytest.approx(0.123)
    assert spec.reader("binning_ms.train")(run) is None


def test_the_stage_metrics_read_the_program_s_stage_names(tmp_path):
    from qed_splatter_tpu_torch import tracing

    from splatbench import harness, spec

    idx = {n: i for i, n in enumerate(tracing.STAGES)}
    ev, t = [], 0.0
    for step in range(2):
        for name, dur in (("step.inputs", 1), ("render.project", 2),
                          ("render.sh", 3), ("render.bin", 4),
                          ("bwd.render.sh", 5), ("bwd.render.project", 6),
                          ("loss.ssim", 7), ("bwd.loss.ssim", 8),
                          ("step.optimizer", 9), ("step.end", 0)):
            ev.append(_x("kernel", f"void stage_mark<{idx[name]}>()", t, 0))
            ev.append(_x("kernel", "work", t, dur))
            t += dur + 1
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    run = harness.Run()
    run.trace = dict(read_trace(path), traced_steps=2, traced_chunks=1)
    got = {m: spec.reader(m)(run) for m in (
        "binning_ms.train", "render_rows_ms.train", "ssim_ms.train",
        "optimizer_ms.train")}
    assert got == pytest.approx({
        "binning_ms.train": 0.004, "render_rows_ms.train": 0.016,
        "ssim_ms.train": 0.015, "optimizer_ms.train": 0.009})
    # no qed.chunk.host range in this trace: nothing to read
    assert spec.reader("chunk_host_idle_ms.train")(run) is None


def test_an_idle_gap_is_named_by_a_range_that_began_many_ranges_before():
    from splatbench.trace import _innermost

    spans = [(0.0, 1000.0, "qed.chunk.host")] + [
        (1.0 + i, 1.5 + i, f"op{i}") for i in range(200)]
    assert _innermost(spans, [300.0, 150.2, 2000.0]) == [
        "qed.chunk.host", "op149", None]


def test_launches_of_stage_marks_outside_the_graph_are_not_counted(
        tmp_path):
    def launch(name, ts, corr):
        return dict(_x("cuda_runtime", name, ts, 2, tid=1),
                    args={"correlation": corr})

    def kernel(name, ts, corr):
        return dict(_x("kernel", name, ts, 1), args={"correlation": corr})

    ev = [launch("cudaGraphLaunch", 0, 1),
          kernel("void stage_mark<0>()", 5, 1),
          kernel("void composite_kernel<4, true>()", 6, 1),
          launch("cudaLaunchKernel", 20, 2),
          kernel("void stage_mark<3>()", 25, 2),
          launch("cudaLaunchKernel", 30, 3),
          kernel("elementwise_kernel", 35, 3)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # the graph's launch and the elementwise kernel's, not the mark's
    assert read_trace(path, ())["launches"] == 2
