"""Rank bodies of ``tests/test_torch_parallel*.py``: each runs in a spawned
process (``parallel/launch.py``) as one gloo rank on the CPU, imports
torch and the port only (never JAX or a test module), and hands its
results back through files.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from qed_splatter_tpu_torch.configs import ModelConfig, default_optimizers
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import from_jax_train_state
from qed_splatter_tpu_torch.models.gaussians import GROUPS
from qed_splatter_tpu_torch.parallel.dp import (
    gather_state,
    make_sharded_train_step,
)
from qed_splatter_tpu_torch.parallel.mesh import init_distributed, make_mesh


def one_thread(fn, *args):
    """``fn(*args)`` on one CPU thread (the tests run several workers, each
    starting up to four ranks), then the job's end."""
    torch.set_num_threads(1)
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def sharded_steps(inp_path: str, out_path: str, mesh_shape, width: int,
                  height: int) -> None:
    """One sharded step of every case in ``inp_path`` (``torch.save`` of
    ``{name: {"state", "batch", "cfg", "need_absgrad", "backgrounds"}}``,
    numpy inside) on this rank's rows and cameras; rank 0 saves each
    case's gathered first moments, statistics and metrics to
    ``out_path``. With no job in the environment it runs the 1x1 mesh in
    this process."""
    init_distributed("cpu")
    mesh = make_mesh(*mesh_shape, device="cpu")
    cases = torch.load(inp_path, weights_only=False)
    out = {}
    for name, c in cases.items():
        state = from_jax_train_state(c["state"], mesh=mesh)
        b_total = c["batch"]["rgb"].shape[0]
        b_local = b_total // mesh.num_data
        lo = mesh.data_index * b_local
        batch = {k: np.asarray(v)[lo:lo + b_local]
                 for k, v in c["batch"].items()}
        step = make_sharded_train_step(
            ModelConfig(**c["cfg"]), GroupOptimizers(default_optimizers()),
            width, height, mesh, has_depth="depth" in batch,
            need_absgrad=c["need_absgrad"])
        bgs = c.get("backgrounds")
        state, metrics = step(state, batch, None,
                              backgrounds=None if bgs is None else
                              torch.as_tensor(bgs))
        full = gather_state(state, mesh)
        out[name] = {
            "mu": {g: full.opt_state[g]["mu"].numpy() for g in GROUPS},
            "count": {g: int(full.opt_state[g]["count"]) for g in GROUPS},
            "camera_mu": full.camera_opt_state["mu"].numpy(),
            "grids_mu": (full.bilateral_grid_state["mu"].numpy()
                         if full.bilateral_grid_state is not None else None),
            "stats": {k: getattr(full.stats, k).numpy() for k in (
                "grad_norm_sum", "vis_count", "max_radii_frac")},
            "means": full.params.means.numpy(),
            "step": full.step,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "local_rows": state.params.capacity,
        }
    if mesh.rank == 0:
        torch.save(out, out_path)


def train(cfg, out_path: str, refine_eps=None) -> None:
    """``Trainer(cfg).train()`` as one rank on the CPU; rank 0 saves the
    mesh it ran on, the gathered final state and every rank's K tables
    (``(step, table before, table after)`` of each adaptive-K call). With
    ``refine_eps`` ({step: [rows, 3] array}), each refine takes its split
    offsets from there instead of the trainer's generator."""
    from qed_splatter_tpu_torch.engine import trainer as trainer_mod
    from qed_splatter_tpu_torch.engine.trainer import Trainer

    plain = trainer_mod.refine

    def given_eps(params, opt_state, stats, step, *args, generator, **kw):
        return plain(params, opt_state, stats, step, *args,
                     eps=torch.as_tensor(refine_eps[int(step)]), **kw)

    t = Trainer(cfg, device="cpu")
    tables = []
    adapt = t._maybe_adapt_k

    def recording(*args, **kw):
        before = dict(t._k_by_d)
        adapt(*args, **kw)
        tables.append((t.state.step, before, dict(t._k_by_d)))

    t._maybe_adapt_k = recording
    if refine_eps is not None:
        trainer_mod.refine = given_eps
    try:
        t.train()
    finally:
        trainer_mod.refine = plain
    full = t._full_state()
    k_tables = [tables]
    if t.mesh is not None:
        k_tables = [None] * dist.get_world_size()
        dist.all_gather_object(k_tables, tables)
    if t.is_writer:
        m = t.mesh
        torch.save({"mesh": ((m.num_data, m.num_model, m.backend) if m
                             else None),
                    "local_capacity": t.state.params.capacity,
                    "alive": full.params.alive.numpy(),
                    "means": full.params.means.numpy(),
                    "step": t.state.step, "k_tables": k_tables,
                    "pid": os.getpid()}, out_path)
