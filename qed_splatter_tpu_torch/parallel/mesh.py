"""The ('data', 'model') mesh as ``torch.distributed`` ranks (port of
``parallel/mesh.py``).

Two axes, as in the JAX package:

- ``data``: view parallelism; each data slice renders its own cameras and
  the gradients are summed over the slices;
- ``model``: gaussian sharding; the capacity rows of the parameters, their
  Adam moments and the densification statistics are split into
  ``num_model`` contiguous blocks, one a rank.

One process per rank replaces JAX's one process driving a ``Mesh`` of
devices. Rank ``r`` sits at data index ``r // num_model`` and model index
``r % num_model`` (JAX's ``reshape(num_data, num_model)``). Its ``data``
group holds the ranks with its model index, its ``model`` group the ranks
with its data index; an axis of size 1 has no group and its collectives
are the identity.

**Device, backend and transport, one rule.** A rank runs on
``cuda:{LOCAL_RANK % device_count}``, or on the CPU when the caller asks
for it. When every rank on the host has a card of its own the backend is
``nccl``; otherwise (ranks sharing a card, or on the CPU) it is ``gloo``.
The layout decides this before ``init_process_group``; nothing is retried
another way after an error. Gloo takes CUDA tensors for each collective
the step calls (all-reduce, and the rows' all-gather and reduce-scatter;
gloo copies them through host memory itself), so the port hands them over
as they are and stages nothing; ``chip_smoke.py`` holds that to
``tools/gloo_probe.py``'s answer on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from qed_splatter_tpu_torch import resolve_device

# the tensor forms of the two row collectives: torch 2.13 renames them
# (``*_single``) and deprecates the older names, which earlier versions
# alone have
_ALL_GATHER = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU
    when ``device`` is the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def backend_for(dev: torch.device) -> str:
    """``nccl`` when every rank on the host has a card of its own, else
    ``gloo`` (ranks that share a card, or ranks on the CPU)."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def host_of_job() -> tuple:
    """(this host's index, the number of hosts) of the job: torchrun's
    ``GROUP_RANK`` and ``WORLD_SIZE / LOCAL_WORLD_SIZE``; (0, 1) for a
    single process. A JAX process is a host, so views shard by host."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return int(os.environ.get("GROUP_RANK", "0")), max(world // local, 1)


def init_distributed(device="cuda") -> Optional[torch.device]:
    """Join the job the environment describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns this rank's
    device. A no-op returning None for a single process. A process group
    that already exists is joined as it is."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not dist.is_initialized():
        return None
    dev = rank_device(device)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(backend_for(dev),
                                init_method=f"tcp://{addr}:{port}",
                                rank=int(os.environ["RANK"]),
                                world_size=world)
    return dev


@dataclasses.dataclass
class Mesh:
    """One rank's view of a (num_data, num_model) mesh."""

    num_data: int
    num_model: int
    rank: int                    # index in the mesh (0 .. D*M - 1)
    data_index: int
    model_index: int
    device: torch.device
    backend: str                 # "gloo", "nccl", or "none" (1x1)
    data_group: Optional[object]   # None when num_data == 1
    model_group: Optional[object]  # None when num_model == 1
    group: Optional[object]        # every rank of the mesh

    # ------------------------------------------------------ collectives

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """Sum (or max) of ``x`` over the ranks of ``axis`` ("data",
        "model" or "mesh"); a new tensor."""
        group = self._group(axis)
        if group is False:
            return x
        rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        out = x.clone()
        dist.all_reduce(out, op=rop, group=group)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ``model`` peers' ``x`` concatenated along the rows, in model
        order ([num_model * rows, ...])."""
        if self.model_group is None:
            return x
        x = x.contiguous()
        out = x.new_empty((self.num_model * x.shape[0], *x.shape[1:]))
        _ALL_GATHER(out, x, group=self.model_group)
        return out

    def reduce_scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ([num_model * rows, ...]) summed over the ``model`` peers,
        each keeping its own block of rows."""
        if self.model_group is None:
            return x
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.num_model, *x.shape[1:]))
        _REDUCE_SCATTER(out, x, group=self.model_group)
        return out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def _group(self, axis: str):
        g = {"data": self.data_group, "model": self.model_group,
             "mesh": self.group}[axis]
        return False if g is None else g


def make_mesh(num_data: int = 1, num_model: int = 1,
              device="cuda") -> Mesh:
    """This rank's :class:`Mesh` of ``num_data x num_model``, the whole
    job. Every rank of the job must call it: each group is made by every
    rank, in one order. A 1x1 mesh needs no job."""
    n = num_data * num_model
    if n == 1 and not dist.is_initialized():
        return Mesh(1, 1, 0, 0, 0, resolve_device(device), "none", None,
                    None, None)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {num_data}x{num_model} needs {n} ranks; "
                         f"the job has {world}")
    grid = [list(range(d * num_model, (d + 1) * num_model))
            for d in range(num_data)]
    mesh_group = dist.new_group(list(range(n))) if n > 1 else None
    data_groups, model_groups = [], []
    if num_data > 1:   # ranks sharing a model index
        data_groups = [dist.new_group([row[m] for row in grid])
                       for m in range(num_model)]
    if num_model > 1:  # ranks sharing a data index
        model_groups = [dist.new_group(row) for row in grid]
    me = dist.get_rank()
    d, m = divmod(me, num_model)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if resolve_device(device).type == "cuda" else torch.device("cpu"))
    return Mesh(num_data, num_model, me, d, m, dev, dist.get_backend(),
                data_groups[m] if data_groups else None,
                model_groups[d] if model_groups else None, mesh_group)
