"""The port's tracing (``qed_splatter_tpu_torch/tracing.py``) on the CPU:
off, a step adds nothing (no ``qed.`` event, no stage node, the same
state); on, the step's stage marks fire in the order of ``STAGES``; a
trainer with ``profile_dir`` on multi-step dispatch writes a trace of a
chunk with its host spans. The graph replays' device marks are held on
the card (marked ``cuda``)."""

import json
import re

import pytest
import torch

from qed_splatter_tpu_torch import tracing
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.engine.checkpoint import copy_state
from qed_splatter_tpu_torch.engine.scan_runner import state_tensors
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.testing import write_synthetic_dataset

MODEL_KW = dict(max_per_tile=16, num_downscales=0, num_random=200,
                camera_opt_mode="SO3xR3", sh_degree=1,
                warmup_length=5, refine_every=6)


@pytest.fixture(autouse=True)
def tracing_restored():
    was = tracing.enabled()
    yield
    tracing.enable(was)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    write_synthetic_dataset(root, num_frames=3, width=16, height=16)
    return root


# the grid's stages, which fire only with the grid on
GRID = ("render.bilagrid", "bwd.render.bilagrid")


def _trainer(dataset, out, device="cpu", grid=False, **kw):
    cfg = TrainerConfig(
        data=DataConfig(data=str(dataset)), output_dir=str(out),
        max_num_iterations=14, steps_per_dispatch=2, steps_per_eval_image=0,
        steps_per_eval_all_images=0, steps_per_save=0,
        model=ModelConfig(**MODEL_KW, use_bilateral_grid=grid), **kw)
    return Trainer(cfg, device=device)


def _fired(grid):
    """The stages in the order a step fires their marks: the table without
    the grid's, and with the grid on its forward after the compositing and
    its backward between the SSIM's and the compositing's."""
    order = [s for s in tracing.STAGES if s not in GRID]
    if grid:
        order.insert(order.index("render.composite") + 1, GRID[0])
        order.insert(order.index("bwd.render.composite"), GRID[1])
    return order


@pytest.fixture(scope="module")
def trainer(dataset, tmp_path_factory):
    return _trainer(dataset, tmp_path_factory.mktemp("out"))


def _profiled_chunk(t, on):
    """One step through the runner's body under the profiler: (the state
    after it, the names of the ``qed.`` events in time order)."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(on)
    runner, _ = t._get_scan_fn(1, 1, True, t.state.params.capacity)
    state = copy_state(t.state, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = runner(state, [0], t._backgrounds(0, 1))
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("qed.")]
    return state, names


def _stage_nodes(t, on):
    """Names of the autograd nodes of one step's render and loss that are
    stage marks."""
    tracing.enable(on)
    step = t._get_scan_fn(1, 1, True, t.state.params.capacity)[0].step
    ds = t._device_dataset(1).data
    batch = {"c2w": ds["c2w"][0], "K": ds["K"][0],
             "cam_idx": int(ds["cam_idx"][0]),
             "rgb": ds["rgb_u8"][0].float() / 255.0, "depth": ds["depth"][0]}
    sg = step.grads(copy_state(t.state, "cpu"), batch,
                    torch.Generator().manual_seed(0))
    seen, todo, marks = set(), [sg.out.rgb.grad_fn, sg.out.depth.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if "BackwardMark" in type(fn).__name__:
            marks.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return marks


def test_tracing_off_adds_no_event_node_or_change(trainer):
    off, names = _profiled_chunk(trainer, False)
    assert names == []
    assert _stage_nodes(trainer, False) == []
    on, _ = _profiled_chunk(trainer, True)
    assert _stage_nodes(trainer, True)
    for a, b in zip(state_tensors(off), state_tensors(on)):
        assert torch.equal(a, b)
    assert off.step == on.step


def test_stage_marks_fire_in_the_order_of_the_table(trainer):
    _, names = _profiled_chunk(trainer, True)
    marks = [n[len("qed.stage."):] for n in names
             if n.startswith("qed.stage.")]
    # without the grid: the table's first 16, the grid's two never
    assert marks == list(tracing.STAGES[:16]) == _fired(False)
    # the forward, then the backward in reverse, then the step's tail
    fwd = list(tracing.STAGES[1:7])
    bwd = [s[len("bwd."):] for s in marks if s.startswith("bwd.")]
    assert bwd == [s for s in reversed(fwd) if s != "render.bin"]
    assert names[:2] == ["qed.chunk.bind", "qed.chunk.replay"]


def test_grid_stage_marks_fire_around_the_slice(dataset, tmp_path):
    """With the grid on, its forward mark fires after the compositing's
    and before the SSIM's; its backward mark after the SSIM's backward
    and before the compositing's."""
    t = _trainer(dataset, tmp_path / "out", grid=True)
    _, names = _profiled_chunk(t, True)
    marks = [n[len("qed.stage."):] for n in names
             if n.startswith("qed.stage.")]
    assert marks == _fired(True)


def test_eval_renders_mark_nothing(trainer):
    """A render outside the step's body (an eval, a viewer frame) launches
    no mark, tracing on or off."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(True)
    item = trainer.dm.get_item(int(trainer.dm.train_indices[0]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer._render_eval(item)
    assert not [e.name for e in prof.events()
                if e.name.startswith("qed.stage.")]


def test_profile_dir_traces_a_chunk_of_the_graph_path(dataset, tmp_path):
    prof = tmp_path / "prof"
    tracing.enable(False)
    t = _trainer(dataset, tmp_path / "out", profile_dir=str(prof))
    assert t._use_scan()
    t.train(finalize=False)
    # on for the train call only
    assert not tracing.enabled()
    # the first chunk from step 10 on (10-11), with its callbacks: the
    # refine at 12
    trace = prof / "trace_steps_10-11.json"
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    for name in ("qed.chunk", "qed.chunk.host", "qed.chunk.bind",
                 "qed.chunk.replay", "qed.adapt", "qed.state_finite",
                 "qed.refine", "qed.refine.densify", "qed.refine.reset",
                 "qed.refine.grow_check"):
        assert name in spans, sorted(spans)
    chunk = spans["qed.chunk"]
    assert chunk["args"]["Concrete Inputs"] == ["10"]
    refine = spans["qed.refine"]
    assert chunk["ts"] <= refine["ts"] <= chunk["ts"] + chunk["dur"]
    assert "Self CPU" in (prof / "key_averages_steps_10-11.txt").read_text()
    rows = [json.loads(x) for x in
            (t.run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if r.get("split") == "train"]
    # no graph on the CPU
    assert train and all(r["graph_captures"] == 0 for r in train)


def _replayed_marks(dataset, tmp_path, grid):
    """The stage indices the device ran, in time order, over three
    replays of a step captured with tracing on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the marks are CUDA kernels)")
    from torch.profiler import ProfilerActivity, profile

    mark = re.compile(r"\bstage_mark<(\d+)>")
    tracing.enable(True)
    t = _trainer(dataset, tmp_path / "out", device="cuda", grid=grid)
    runner, _ = t._get_scan_fn(1, 3, True, t.state.params.capacity)
    state, _ = runner(t.state, t._next_perm(3), t._backgrounds(0, 3))
    assert (runner.captures, runner.replays) == (1, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner(state, t._next_perm(3), t._backgrounds(3, 3))
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    marks = sorted((e["ts"], int(mark.search(e["name"]).group(1)))
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"
                   and mark.search(e.get("name", "")))
    return [i for _, i in marks]


@pytest.mark.cuda
def test_graph_replays_run_every_mark_once_a_step(dataset, tmp_path):
    """Each replay of a step captured with tracing on runs the stage marks
    as device kernels, in the order of the table, once a step: without the
    grid, the table's first 16 (the grid's two come last)."""
    got = _replayed_marks(dataset, tmp_path, grid=False)
    assert got == list(range(16)) * 3
    assert got == [tracing.INDEX[s] for s in _fired(False)] * 3


@pytest.mark.cuda
def test_graph_replays_run_the_grid_marks_once_a_step(dataset, tmp_path):
    """With the grid on, each replay runs its two marks besides, where
    they fire: after the compositing's and before the compositing's
    backward."""
    got = _replayed_marks(dataset, tmp_path, grid=True)
    assert got == [tracing.INDEX[s] for s in _fired(True)] * 3
