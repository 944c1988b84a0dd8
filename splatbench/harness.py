"""One run of one cell: set-up, the first steps, the window, the trace and
the check against the reference.

The path the window drives is what ``cli train`` runs: the program's
``Trainer``, resumed from the state :mod:`splatbench.scene` makes from
the seed (with the K and pair budget a checkpoint's metadata would
restore: those the program's own trainer settled on such a state, kept in
``splatbench/states/<cell>.json``), on its default
multi-step dispatch, a CUDA graph of the step replayed per step in chunks
of ``log_every`` steps, with refine and the eval image between chunks.
With the model's bilateral grid on, the made state carries the per-camera
colour grids and their Adam state, and the check compares them as one
more leaf.

Set-up drives that same trainer from the resume step through its first
three steps, a chunk of one step and then one of two, ending on a refine;
the program's readings of them are kept and the reference follows them
after the window (:mod:`splatbench.check`). Set-up then runs chunks of the
window's size until the trainer's own rules leave K and the pair budget
where they are, so that the window's graph is captured before it opens.
A traced run (``--trace 1``) turns the program's tracing on before set-up,
so the captured step marks its stages on the device and the trainer names
its host work; an untraced run leaves it off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from qed_splatter_tpu_torch import cuda as qcuda
from qed_splatter_tpu_torch.configs import (
    AdamConfig,
    DataConfig,
    ModelConfig,
    TrainerConfig,
)
from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
from qed_splatter_tpu_torch.engine.densify import DensifyStats
from qed_splatter_tpu_torch.engine.train_step import TrainState
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.models.gaussians import GaussianParams

from splatbench import check, scene, yardstick
from splatbench.reference import data as rdata
from splatbench.spec import Cell
from splatbench.trace import read_trace

GROUPS = scene.GROUPS
B1 = 0.9


@dataclasses.dataclass
class Run:
    """What the metric readers read (``splatbench/metrics/*.py``)."""

    steps: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    peak_bytes: int = 0
    refine_ms: list = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None     # read_trace() plus traced_steps
    counts: Optional[dict] = None    # yardstick sums over the traced steps


class BenchTrainer(Trainer):
    """The program's trainer, resumed from a state made in memory: the
    state and the adaptive tables stand where ``load_dir`` would restore a
    checkpoint's. It keeps the journal key of every chunk it dispatches
    (the K and pair budget the chunk ran at) and, while ``keep_metrics``
    is set, the chunk's per-step metrics as the runner returned them."""

    def __init__(self, config, state, k, tpg, **kw):
        self._resume = (state, k, tpg)
        self.chunks = []
        self.keep_metrics = False
        super().__init__(config, **kw)

    def _setup_state(self):
        state, k, tpg = self._resume
        self._resume = None
        self._k_by_d[1] = int(k)
        self._tpg_by_d[1] = int(tpg)
        return state

    def _refine(self, cur, max_hw):
        if self.keep_metrics:
            st = self.state.stats
            self.pre_refine_stats = {
                "grad_norm_sum": st.grad_norm_sum.detach().clone(),
                "vis_count": st.vis_count.detach().clone()}
        return super()._refine(cur, max_hw)

    def _dispatch_journaled(self, key, fn, *args):
        out = super()._dispatch_journaled(key, fn, *args)
        if key.get("kind") == "step":
            self.chunks.append({
                "key": dict(key),
                "metrics": (dict(zip(fn.names, out[1].cpu().numpy().T))
                            if self.keep_metrics else None)})
        return out


def trainer_config(cell: Cell, data_dir: Path, out_dir: Path,
                   seed: int) -> TrainerConfig:
    cfg = cell.config
    return TrainerConfig(
        data=DataConfig(data=str(data_dir), **cfg["data"]),
        model=ModelConfig(**cfg["model"]),
        optimizers={g: AdamConfig(**o) for g, o in cfg["optimizers"].items()},
        output_dir=str(out_dir), experiment_name="run", seed=int(seed),
        vis="jsonl", **cfg["trainer"])


def program_state(S: dict) -> TrainState:
    """The program's state on the tensors of ``S`` (shared, not copied)."""
    dev = S["params"]["means"].device

    def adam(s):
        return {"count": torch.full((), int(s["count"]), dtype=torch.int32,
                                    device=dev),
                "mu": s["mu"], "nu": s["nu"]}

    grids = S.get("bilateral_grids")
    return TrainState(
        params=GaussianParams(**S["params"]),
        opt_state={g: adam(S["opt"][g]) for g in GROUPS},
        camera_opt=S["camera_opt"],
        camera_opt_state=adam(S["camera_opt_state"]),
        stats=DensifyStats(**S["stats"]),
        step=int(S["step"]),
        bilateral_grids=grids,
        bilateral_grid_state=(adam(S["bilateral_grid_state"])
                              if grids is not None else None))


def _rows(run_dir: Path, split: str):
    path = run_dir / "metrics.jsonl"
    if not path.exists():
        return []
    return [r for r in map(json.loads, path.read_text().splitlines())
            if r.get("split") == split]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(trainer, S0_params, S0_stats, absgrad: bool) -> dict:
    """The program's readings of the first three steps: the first alone
    (its gradient of each leaf, from the first moment), then the second
    and third as one chunk, on the chunk runner's second position, ending
    on the refine. Each step's loss and the K and pair budget it ran at,
    the statistics' change over the three steps as the refine reads it,
    and after the refine the alive mask, each leaf's change per row and
    the rows' squared norms; with the grid on, the grids' first gradient
    and the grids after the three steps."""
    start = trainer.state.step
    out = {"grad_norm": {}}
    trainer.keep_metrics = True
    n0 = len(trainer.chunks)
    trainer.train(max_steps=start + 1, finalize=False)
    st = trainer.state
    for g in GROUPS:
        out["grad_norm"][g] = float(
            st.opt_state[g]["mu"].double().norm()) / (1.0 - B1)
    out["grad_norm"]["camera_opt"] = float(
        st.camera_opt_state["mu"].double().norm()) / (1.0 - B1)
    if st.bilateral_grids is not None:
        out["grad_norm"]["bilateral_grid"] = float(
            st.bilateral_grid_state["mu"].double().norm()) / (1.0 - B1)
    trainer.pre_refine_stats = None
    trainer.train(max_steps=start + 3, finalize=False)
    trainer.keep_metrics = False
    chunks = trainer.chunks[n0:]
    out["loss"] = [float(v) for c in chunks for v in c["metrics"]["loss"]]
    for name in ("k", "tpg"):
        out[name] = [c["key"][name] for c in chunks
                     for _ in range(c["key"]["chunk"])]
    if len(out["loss"]) != 3:
        raise RuntimeError(f"the first steps ran as {len(chunks)} chunks "
                           f"of {[c['key']['chunk'] for c in chunks]} steps")
    if absgrad:
        pre = trainer.pre_refine_stats
        out["stats_grad"] = float(
            (pre["grad_norm_sum"].double()
             - S0_stats["grad_norm_sum"].double()).norm())
        out["stats_vis"] = float(
            (pre["vis_count"] - S0_stats["vis_count"]).sum())
    st = trainer.state
    p = st.params
    out["alive"] = p.alive.cpu()
    out["change_sq"] = {g: check.row_sq(getattr(p, g) - S0_params[g])
                        for g in GROUPS}
    out["row_sq"] = {g: check.row_sq(getattr(p, g)) for g in GROUPS}
    out["camera_opt"] = st.camera_opt.detach().double().cpu()
    if st.bilateral_grids is not None:
        out["bilateral_grids"] = st.bilateral_grids.detach().double().cpu()
    return out


def prepare(cell: Cell, seed: int, dev) -> dict:
    """Set-up up to the window: the dataset, the extensions, the state,
    the trainer at the cell's K and pair budget, and its first three steps
    (the program's readings). Returns the pieces, with ``parts`` (seconds
    by part) and ``t_all`` (the start on the host clock)."""
    cfg, traffic = cell.config, cell.traffic
    parts = {}
    t_all = t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        _sync(dev)
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - t0
        t0 = now

    data_dir = scene.dataset_dir(cfg)
    part("dataset")
    if dev.type == "cuda":
        qcuda.build(qcuda.sources())
    part("extensions")
    scn = rdata.load_scene(data_dir, cfg["data"])
    S0 = scene.synthesize(scn, cfg, traffic, cell.state, seed, dev)
    p0 = {g: S0["params"][g].clone() for g in GROUPS}
    stats0 = {k: v.clone() for k, v in S0["stats"].items()}
    part("state")
    work = Path(tempfile.mkdtemp(prefix="splatbench-"))
    tcfg = trainer_config(cell, data_dir, work, seed)
    dm = FullImageDatamanager(tcfg.data, seed=tcfg.seed)
    with contextlib.redirect_stdout(sys.stderr):
        trainer = BenchTrainer(tcfg, program_state(S0),
                               cell.state["max_per_tile"],
                               cell.state["small_tiles_per_gaussian"],
                               datamanager=dm, device=dev)
        del S0
        part("trainer")
        readings = first_steps(trainer, p0, stats0, traffic["absgrad"])
        del p0, stats0
        part("first_steps")
    return {"scn": scn, "trainer": trainer, "readings": readings,
            "parts": parts, "part": part, "t_all": t_all, "work": work}


def program_readings(cell: Cell, seed: int, dev) -> dict:
    """The program's readings of the first steps alone (no window), with
    the trainer freed: what the limit runs compare."""
    pre = prepare(cell, seed, dev)
    del pre["trainer"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(pre["work"], ignore_errors=True)
    return pre


def _tables(trainer) -> tuple:
    return trainer._k_for(1), trainer._tpg_for(1)


def _program_tracing(trace: bool):
    """The program's tracing on for the block where ``trace`` (a program
    without the tracing module runs untraced); as it was after."""
    if not trace:
        return contextlib.nullcontext()
    try:
        from qed_splatter_tpu_torch import tracing
    except ImportError:
        return contextlib.nullcontext()
    return tracing.on(True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", log=None) -> dict:
    """One run; returns the result's fields (and ``run``, ``checks``)."""
    with _program_tracing(trace):
        return _run_cell(cell, seed, seconds, trace, device, log)


def _run_cell(cell, seed, seconds, trace, device, log) -> dict:
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    traffic, model = cell.traffic, cell.config["model"]
    pre = prepare(cell, seed, dev)
    scn, trainer, readings, parts, part, work, t_all = (
        pre["scn"], pre["trainer"], pre["readings"], pre["parts"],
        pre["part"], pre["work"], pre["t_all"])
    del pre
    refine_every = int(model["refine_every"])
    with contextlib.redirect_stdout(sys.stderr):
        chunk = trainer.config.log_every
        # the window's graph, captured again while the program's own rules
        # still move K or the pair budget (at most four chunks)
        for _ in range(4):
            before = _tables(trainer)
            trainer.train(max_steps=trainer.state.step + chunk,
                          finalize=False)
            if _tables(trainer) == before:
                break
        part("graph_captures")
        setup_s = time.perf_counter() - t_all
        run = Run(setup_s=setup_s)
        n_refine_before = len(_rows(trainer.run_dir, "refine"))
        n_keys = len(trainer.chunks)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        traced = None
        trace_chunks = int(traffic["trace_chunks"])
        prof = None
        chunk_s = []    # (seconds, step at its end) of each chunk
        t_w = time.perf_counter()
        n_chunks = 0
        while True:
            # the trace opens on the first chunk after a refine, so every
            # traced step runs on the rows it leaves; the state then is the
            # one the yardstick counts
            if (trace and traced is None and prof is None and n_chunks >= 1
                    and trainer.state.step % refine_every == 0):
                snap = {g: getattr(trainer.state.params, g).detach().clone()
                        for g in ("means", "quats", "scales", "opacities",
                                  "alive")}
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
                traced_from, traced_keys = trainer.state.step, \
                    len(trainer.chunks)
                traced_at = n_chunks
            t_c = time.perf_counter()
            trainer.train(max_steps=trainer.state.step + chunk,
                          finalize=False)
            chunk_s.append((time.perf_counter() - t_c, trainer.state.step))
            n_chunks += 1
            run.steps += chunk
            if prof is not None and n_chunks == traced_at + trace_chunks:
                _sync(dev)
                prof.stop()
                path = work / "trace.json"
                prof.export_chrome_trace(str(path))
                traced = (path, traced_from, trainer.state.step,
                          [c["key"] for c in trainer.chunks[traced_keys:]])
                prof = None
            if (time.perf_counter() - t_w >= seconds
                    and (not trace or traced is not None)):
                break
        _sync(dev)
        run.window_s = time.perf_counter() - t_w
        slow = sorted(chunk_s, reverse=True)[:3]
        log(f"window: {len(chunk_s)} chunks, median "
            f"{sorted(chunk_s)[len(chunk_s) // 2][0]:.4f} s, slowest "
            + ", ".join(f"{t:.4f} s to step {s}" for t, s in slow))
        if dev.type == "cuda":
            run.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        window_keys = trainer.chunks[n_keys:]
        rows = _rows(trainer.run_dir, "train")
        window_rows = rows[-len(window_keys):]
        failed = chunk * sum(
            1 for r in window_rows
            if not (math.isfinite(r.get("loss", float("nan")))
                    and math.isfinite(r.get("loss_max", 0.0))))
        run.refine_ms = [r["ms"] for r in
                         _rows(trainer.run_dir, "refine")[n_refine_before:]]
        tables = sorted({(c["key"]["k"], c["key"]["tpg"])
                         for c in window_keys})
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if len(tables) > 1:
        log(f"the window ran at K and pair budget {tables}: a graph was "
            "captured inside it")
    if traced is not None:
        run.trace = read_trace(traced[0])
        run.trace["traced_steps"] = traced[2] - traced[1]
        run.trace["traced_chunks"] = len(traced[3])
        positions = scene.camera_sequence(
            seed, int(traffic["resume_step"]), len(scn.train_indices),
            traced[1], traced[2] - traced[1])
        per_step = [(c["k"], c["tpg"]) for c in traced[3]
                    for _ in range(c["chunk"])]
        run.counts = _traced_counts(snap, scn, model, positions, per_step,
                                    traffic["absgrad"])
        del snap
    checks = check.check_cell(cell, scn, seed, readings, dev)
    return {"run": run, "checks": checks, "attempted": run.steps,
            "failed": failed, "setup_parts": parts, "tables": tables,
            "work": work}


def _traced_counts(params, scn, model, positions, per_step, absgrad):
    """The yardstick's sums over the traced steps: each step's camera at
    the K and pair budget its chunk ran at, on the rows the traced stretch
    ran on (the state where it opened, after a refine)."""
    alive = int(params["alive"].sum())
    rows = []
    cache = {}
    for pos, (k, tpg) in zip(positions, per_step):
        if (pos, k, tpg) not in cache:
            fr = scn.frames[int(scn.train_indices[pos])]
            need = yardstick.needed_pairs(
                params, {"c2w": fr.c2w, "K": fr.K, "width": fr.width,
                         "height": fr.height}, model, k, tpg)
            cache[(pos, k, tpg)] = yardstick.step_counts(need, alive, absgrad)
        rows.append(cache[(pos, k, tpg)])
    out = yardstick.sum_counts(rows)
    out["steps"] = len(rows)
    return out
