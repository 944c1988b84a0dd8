"""Gather placements around the identity copy, timed on the GPU (port of
``tools/bench_gather3.py``).

    python -m qed_splatter_tpu_torch.tools.bench_gather3 [--device cuda]

The JAX tool put a Pallas identity copy before and after the dense step's
big row gathers (a 327,680 x 10 table gathered to 4,396,032 rows; a
permutation of 4,396,032 rows) because a Pallas call pins its operand and
result to row-major layout, and that undid XLA's slow column-major gather
fusions on the TPU. A CUDA tensor has one (strided) layout, so that question
does not arise here; the copy (``csrc/copy_rows.cu``, the port of the JAX
tool's Pallas kernel) is timed in the same placements anyway, under the
same names, each followed by the tool's consumer (a sum over the rows), and
on its own beside its plain version (``clone``) and ``Tensor.copy_`` into a
preallocated tensor.

Times are device milliseconds per call from ``utils/microbench.py``. Holds
the GPU lock; prints one line per placement and ONE JSON dict at the end.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

N_TAB, M_IDX, C = 327_680, 4_396_032, 10


def run(device="cuda", n_calls=15, log=print, sizes=(N_TAB, M_IDX)) -> dict:
    """{placement: ms per call}; ``sizes`` (table rows, gathered rows)
    shrink it for a rehearsal."""
    from qed_splatter_tpu_torch.ops.copy_rows import copy_rows, copy_rows_ref
    from qed_splatter_tpu_torch.utils import microbench

    dev = torch.device(device)
    n_tab, m_idx = sizes
    rng = np.random.default_rng(0)
    times = {}

    def t(name, op, args, n=n_calls):
        if dev.type == "cuda":
            ms = microbench.device_time_per_call(op, args, n=n) * 1e3
            method = microbench.last_method
        else:                        # a rehearsal: one call, no time
            op(*args)
            ms, method = float("nan"), "cpu"
        times[name] = ms
        if method == "eager":
            times[f"{name}:eager"] = True
        log(f"{name} {ms:.4f} ms ({method})")

    tab = torch.as_tensor(rng.uniform(0, 1, (n_tab, C)).astype(np.float32),
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, n_tab, m_idx).astype(np.int64),
                          device=dev)
    big = torch.as_tensor(rng.uniform(0, 1, (m_idx, C)).astype(np.float32),
                          device=dev)
    perm = torch.as_tensor(rng.permutation(m_idx).astype(np.int64),
                           device=dev)

    def consume(rows):               # the tool's reduction-style consumer
        return rows.sum(0)

    cp = copy_rows
    t("gather_plain", lambda i: consume(tab[i]), (idx,))
    t("gather_pallas_out", lambda i: consume(cp(tab[i])), (idx,))
    t("gather_pallas_in", lambda i: consume(cp(tab)[i]), (idx,))
    t("gather_pallas_both", lambda i: consume(cp(cp(tab)[i])), (idx,))
    t("perm_plain", lambda p: consume(big[p]), (perm,))
    t("perm_pallas_in", lambda p: consume(cp(big)[p]), (perm,))
    t("perm_pallas_both", lambda p: consume(cp(cp(big)[p])), (perm,))
    idx_sorted = torch.sort(idx).values
    t("gather_sorted_plain", lambda i: consume(tab[i]), (idx_sorted,))
    t("gather_sorted_pallas_both", lambda i: consume(cp(cp(tab)[i])),
      (idx_sorted,))
    # the copy alone at both sizes: the kernel, its plain version, the
    # library's copy into a preallocated tensor
    for label, x in (("327k", tab), ("4p4M", big)):
        dst = torch.empty_like(x)
        t(f"copy_{label}", cp, (x,))
        t(f"copy_{label}_plain", copy_rows_ref, (x,))
        t(f"copy_{label}_library", lambda a, b=dst: b.copy_(a), (x,))
    return times


def main(argv=None) -> int:
    from qed_splatter_tpu_torch import resolve_device
    from qed_splatter_tpu_torch.utils.chiplock import acquire_chip_lock

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    acquire_chip_lock("tools.bench_gather3", device=dev)
    times = run(dev, log=lambda s: print(s, flush=True))
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in times.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
