"""Chunked brute-force k-nearest-neighbours (port of ``ops/knn.py``).

Splatfacto's scale initializer needs the mean distance to the 3 nearest
other points. Brute force in query chunks bounds memory at [chunk, M];
``torch.cdist`` in its matmul mode is the same |a|^2 + |b|^2 - 2 a.b
expansion the JAX version writes out, run in full float32 (the callers'
parity paths keep TF32 off).
"""

from __future__ import annotations

import torch


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int,
        exclude_self: bool = False, chunk: int = 4096):
    """(distances [Q, k], indices [Q, k]) of the k nearest refs per query.
    ``exclude_self`` requires ``queries`` to be ``refs``."""
    if exclude_self and queries.shape != refs.shape:
        raise ValueError("exclude_self needs queries == refs")
    q = queries.float()
    r = refs.float()
    dists, idxs = [], []
    for s in range(0, q.shape[0], chunk):
        d = torch.cdist(q[s:s + chunk], r,
                        compute_mode="use_mm_for_euclid_dist")
        if exclude_self:
            # queries are the refs: drop each point's own column by index.
            # (The JAX package masks d^2 <= 1e-12 instead, which misses
            # self-distances that the expansion's rounding leaves above
            # that.) A duplicated point still finds its duplicate at 0.
            rows = torch.arange(d.shape[0], device=d.device)
            d[rows, rows + s] = torch.inf
        v, i = torch.topk(d, k, dim=-1, largest=False)
        dists.append(v)
        idxs.append(i)
    return torch.cat(dists), torch.cat(idxs)


def mean_knn_distance(points: torch.Tensor, k: int = 3,
                      chunk: int = 4096) -> torch.Tensor:
    """Mean distance to the k nearest *other* points ([N])."""
    k = min(k, max(points.shape[0] - 1, 1))  # tiny clouds
    d, _ = knn(points, points, k=k, exclude_self=True, chunk=chunk)
    d = torch.where(torch.isfinite(d), d, 0.0)
    return d.mean(-1)
