"""Exact k-nearest-neighbour graph — the port of ``vq_tpu.ops.knn``.

The corpus scans itself through :class:`vq_tpu_torch.search.FlatIndex`,
one query batch at a time, so the working set is ``[query_batch,
fetch + chunk]`` whatever n is: an n x n distance matrix never exists.
Each batch is searched as it stands (the JAX package pads its last batch
to the compiled shape; eager PyTorch needs no padding), so a row's
neighbours do not depend on ``query_batch`` beyond the last bits of the
product's summation order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import as_tensor
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.search import FlatIndex

__all__ = ["knn_graph"]


def knn_graph(
    data,
    k: int = 10,
    *,
    metric: str = "squared_euclidean",
    include_self: bool = False,
    query_batch: int = 1024,
    chunk: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN graph over ``data`` rows, on ``data``'s device (or
    ``device``; the card by default).

    Returns ``(ids [n, k] int32, values [n, k])`` — ascending distances
    (or descending scores for ``metric="dot"``). ``include_self=False``
    (default) fetches one extra neighbour and drops each row's self-match
    by id, not by value (with ``dot`` or duplicate rows the self-match
    need not come first), then re-sorts stably. ``ids`` of -1 and values
    of +inf (-inf for dot) pad rows when fewer than k neighbours exist
    (n <= k).
    """
    x = as_tensor(data, device).to(torch.float32)
    if x.ndim != 2 or x.shape[0] == 0:
        raise InvalidParameter("data", "expected a non-empty [n, d] array")
    k = int(k)
    if k < 1:
        raise InvalidParameter("k", "must be >= 1")
    n = x.shape[0]
    idx = FlatIndex.from_data(x, metric=metric)
    dot = idx.metric == "dot"
    worst = float("-inf") if dot else float("inf")
    fetch = min(k + (0 if include_self else 1), n)
    qb = max(1, min(int(query_batch), n))

    out_ids, out_vals = [], []
    for start in range(0, n, qb):
        stop = min(start + qb, n)
        ids, vals = idx.search(x[start:stop], k=fetch, chunk=chunk)
        if not include_self:
            rows = torch.arange(start, stop, dtype=torch.int32, device=x.device)[:, None]
            self_hit = ids == rows
            vals = torch.where(self_hit, worst, vals)
            ids = torch.where(self_hit, -1, ids)
            pos = _smallest(-vals if dot else vals, k)[1]
            ids, vals = torch.gather(ids, 1, pos), torch.gather(vals, 1, pos)
        ids, vals = ids[:, :k], vals[:, :k]
        if ids.shape[1] < k:  # n <= k: pad out the contract
            pad = k - ids.shape[1]
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            vals = torch.nn.functional.pad(vals, (0, pad), value=worst)
        out_ids.append(ids)
        out_vals.append(vals)
    return torch.cat(out_ids), torch.cat(out_vals)
