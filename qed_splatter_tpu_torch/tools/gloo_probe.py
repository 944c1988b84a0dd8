"""Which ``torch.distributed`` collectives the gloo backend runs on tensors
of a device, and whether each gives the right answer.

    python -m qed_splatter_tpu_torch.tools.gloo_probe [--device cuda]
        [--ranks 2]

Starts ``--ranks`` processes on one host, all on the same device (``cuda``
means ``cuda:0`` for every rank: ranks that share a card, the layout that
``parallel/mesh.py`` runs over gloo), and tries each collective the sharded
step uses, and its older or newer spellings, on a tensor of that device.
Prints the torch version and ONE JSON dict: ``{op: "ok" | "wrong" |
"raises: <error>"}``. ``parallel/mesh.py`` hands gloo CUDA tensors for
the collectives the step calls and stages none; ``chip_smoke.py``'s
sharded phase runs :func:`probe_ops` in its ranks and holds each of those
collectives to "ok" on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

OPS = ("all_reduce_sum", "all_reduce_max", "all_gather",
       "all_gather_into_tensor", "all_gather_single", "reduce_scatter",
       "reduce_scatter_tensor", "reduce_scatter_single", "broadcast")


def _try(name, dev, rank, world):
    n = 4
    x = torch.arange(n * world, dtype=torch.float32, device=dev) + rank
    if name == "all_reduce_sum":
        y = x.clone()
        dist.all_reduce(y)
        want = x * world + sum(range(world)) - rank * world
    elif name == "all_reduce_max":
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        want = x - rank + world - 1
    elif name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        y = torch.cat(parts)
        want = torch.cat([x - rank + r for r in range(world)])
    elif name in ("all_gather_into_tensor", "all_gather_single"):
        y = torch.empty(n * world * world, device=dev)
        getattr(dist, name)(y, x)
        want = torch.cat([x - rank + r for r in range(world)])
    elif name == "reduce_scatter":
        y = torch.empty(n, device=dev)
        dist.reduce_scatter(y, list(x.chunk(world)))
        full = x * world + sum(range(world)) - rank * world
        want = full.chunk(world)[rank]
    elif name in ("reduce_scatter_tensor", "reduce_scatter_single"):
        y = torch.empty(n, device=dev)
        getattr(dist, name)(y, x)
        full = x * world + sum(range(world)) - rank * world
        want = full.chunk(world)[rank]
    else:  # broadcast from rank 0
        y = x.clone()
        dist.broadcast(y, 0)
        want = x - rank
    return "ok" if torch.equal(y.cpu(), want.cpu()) else "wrong"


def probe_ops(dev: torch.device) -> dict:
    """{op: answer} of every op of :data:`OPS` on ``dev``'s tensors, over
    the default group of a job that is already running (every rank calls
    it)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}
    for name in OPS:
        if not hasattr(dist, name.replace("_sum", "").replace("_max", "")):
            res[name] = "absent"
            continue
        try:   # a probe: each op's refusal is the answer sought
            res[name] = _try(name, dev, rank, world)
        except Exception as e:  # noqa: BLE001
            res[name] = f"raises: {type(e).__name__}: {str(e)[:160]}"
        dist.barrier()
    return res


def _rank(rank, world, device, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    res = probe_ops(torch.device("cuda:0" if device == "cuda" else "cpu"))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def probe(device="cuda", ranks=2) -> dict:
    """{op: answer} from ``ranks`` gloo processes on ``device``."""
    from qed_splatter_tpu_torch.parallel.launch import free_port, spawn

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.json")
        spawn(_rank, ranks, (ranks, device, free_port(), out), timeout=300)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(json.dumps(probe(args.device, args.ranks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
