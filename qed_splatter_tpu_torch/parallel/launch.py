"""Starting the ranks of a job on one host.

``cli train --num-data-shards D --num-model-shards M`` without a job in the
environment (no ``WORLD_SIZE``) starts its own ``D * M`` ranks here: spawned
processes (never forked: the launcher may hold CUDA state and threads),
each with the environment ``torchrun`` would give it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). A rank that fails ends the job: the
others are terminated and the child's traceback is raised in the launcher
(``torch.multiprocessing``'s process context), so a failed rank never
leaves the job exiting 0.
"""

from __future__ import annotations

import os
import socket
import sys
import time
import traceback
from typing import Optional

import torch.multiprocessing as tmp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """The environment of one rank of a one-host job of ``world`` ranks."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "GROUP_RANK": "0", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def spawn(fn, nprocs: int, args=(),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait for
    all of them. Raises the first failure (the others are terminated), or
    :class:`TimeoutError` after ``timeout`` seconds (all killed)."""
    ctx = tmp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                              join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=None if deadline is None else max(
            deadline - time.monotonic(), 0.0)):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            raise TimeoutError(f"{nprocs} ranks of {fn.__qualname__} did "
                               f"not finish within {timeout:.0f} s")


def run_rank(rank: int, fn, world: int, port: int, args=()) -> None:
    """The body of a spawned rank: its environment, then ``fn(*args)``. A
    failure's traceback is printed with the rank's number before it is
    raised: the launcher raises only the first rank to exit, which may be
    a peer that lost its connection to the one at fault."""
    os.environ.update(rank_env(rank, world, port))
    try:
        fn(*args)
    except BaseException:
        print(f"rank {rank} of {world} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
