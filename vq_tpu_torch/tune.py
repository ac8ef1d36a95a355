"""Runtime-parameter autotuning, the faiss ``ParameterSpace`` /
``OperatingPoints`` analog — the port of ``vq_tpu.tune``.

Every approximate index has a search-time knob (``nprobe`` for the IVF
family, ``beam`` for the graph, ``rerank`` for the coded flat scans,
``k_factor`` for a refine index). This module measures the recall /
latency operating points of an index over a parameter grid and picks the
cheapest configuration that meets a recall target:

    gt, _ = exact_neighbors(corpus, queries, k=10)
    ops = sweep(index, queries, gt)             # default grid for the type
    best = tune(index, queries, gt, target_recall=0.95)
    index.search(queries, 10, **best.params)

A search is timed on the host clock up to the copy of its ids to the
host, which waits for the card to finish the search, so the time covers
the device work.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import InvalidParameter

__all__ = [
    "OperatingPoint",
    "exact_neighbors",
    "recall_at",
    "sweep",
    "pareto",
    "tune",
    "default_grid",
]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclass(frozen=True)
class OperatingPoint:
    """One measured (parameters -> quality / cost) point."""

    params: Dict[str, int] = field(compare=False)
    recall: float = 0.0
    time_ms: float = 0.0  # a query batch
    qps: float = 0.0

    def dominates(self, other: "OperatingPoint") -> bool:
        """At least as good on both axes, strictly better on one."""
        return (
            self.recall >= other.recall
            and self.time_ms <= other.time_ms
            and (self.recall > other.recall or self.time_ms < other.time_ms)
        )


def exact_neighbors(corpus, queries, k: int = 10, *, metric: str = "squared_euclidean",
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth top-k ``(ids [Q, k], values [Q, k])`` as numpy arrays,
    by an exact :class:`~vq_tpu_torch.search.FlatIndex` scan on the
    corpus's device (or ``device``)."""
    from vq_tpu_torch.search import FlatIndex

    idx = FlatIndex.from_data(corpus, metric=metric, device=device)
    ids, vals = idx.search(queries, k)
    return _host(ids), _host(vals)


def recall_at(ids, gt_ids) -> float:
    """Fraction of ground-truth neighbours retrieved (set intersection a
    query, the standard recall@k). ``-1`` padding never matches."""
    ids = _host(ids)
    gt = _host(gt_ids)
    if ids.shape[0] != gt.shape[0]:
        raise InvalidParameter("ids", f"query counts differ: {ids.shape[0]} vs {gt.shape[0]}")
    hits = 0
    for row, gt_row in zip(ids, gt):
        hits += np.intersect1d(row[row >= 0], gt_row[gt_row >= 0]).size
    return hits / max(int((gt >= 0).sum()), 1)


def default_grid(index, k: int = 10) -> Dict[str, Sequence[int]]:
    """A sweep grid for the index's type (the ``ParameterSpace``
    heuristics): ``nprobe`` doublings for the IVF family, ``beam`` for the
    graph, ``rerank`` multiples of k for coded scans with a kept corpus,
    ``k_factor`` for a refine index."""
    from vq_tpu_torch.factory import FactoryIndex, IdMapIndex
    from vq_tpu_torch.graph import GraphIndex
    from vq_tpu_torch.ivf import IVFPQIndex
    from vq_tpu_torch.ivf_flat import _IVFScanBase
    from vq_tpu_torch.refine import RefineIndex
    from vq_tpu_torch.search import PQIndex, RQIndex, SQIndex
    from vq_tpu_torch.transforms import TransformedIndex

    if isinstance(index, FactoryIndex):
        return default_grid(index.index, k)
    if isinstance(index, (IdMapIndex, TransformedIndex)):
        return default_grid(index.base, k)
    if isinstance(index, RefineIndex):
        grid = dict(default_grid(index.base, k))
        grid.pop("rerank", None)  # the refiner is the rerank stage
        grid["k_factor"] = [1, 2, 4, 8, 16]
        return grid
    if isinstance(index, (_IVFScanBase, IVFPQIndex)):
        nlist = index.nlist
        probes = [p for p in (1, 2, 4, 8, 16, 32, 64, 128) if p <= nlist]
        if not probes or probes[-1] != nlist:
            probes.append(nlist)
        grid: Dict[str, Sequence[int]] = {"nprobe": probes}
        if getattr(index, "_corpus", None) is not None:
            grid["rerank"] = [0, 4 * k, 16 * k]
        return grid
    if isinstance(index, GraphIndex):
        return {"beam": [8, 16, 32, 64]}
    if isinstance(index, (PQIndex, RQIndex, SQIndex)):
        if getattr(index, "_corpus", None) is not None:
            return {"rerank": [0, 2 * k, 4 * k, 16 * k]}
        return {}
    return {}  # exact indexes: nothing to tune


def _timed_search(index, queries, k: int, params: Dict, reps: int):
    """``(ids as numpy, best seconds)`` over ``reps`` searches. Each time
    ends with the copy of the ids to the host, which on the card waits
    for the search to finish."""
    best = float("inf")
    ids = None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        ids, _ = index.search(queries, k, **params)
        ids = _host(ids)
        best = min(best, time.perf_counter() - t0)
    return ids, best


def sweep(index, queries, gt_ids, *, k: Optional[int] = None,
          grid: Optional[Dict[str, Sequence[int]]] = None, reps: int = 2) -> List[OperatingPoint]:
    """Recall and latency at every grid point (the cartesian product).

    ``gt_ids`` is the exact top-k (:func:`exact_neighbors`); ``k``
    defaults to its width. Each point is searched ``reps`` times and the
    fastest kept (the first call builds what the search caches). Returns
    the points in grid order."""
    gt = _host(gt_ids)
    if k is None:
        k = int(gt.shape[1])
    if grid is None:
        grid = default_grid(index, k)
    names = sorted(grid)
    combos = ([dict(zip(names, vals)) for vals in itertools.product(*(grid[n] for n in names))]
              if names else [{}])
    nq = int(queries.shape[0]) if hasattr(queries, "shape") else len(queries)
    points = []
    for params in combos:
        ids, secs = _timed_search(index, queries, k, params, reps)
        points.append(OperatingPoint(
            params=params, recall=recall_at(ids, gt), time_ms=secs * 1e3,
            qps=nq / secs if secs > 0 else float("inf")))
    return points


def pareto(points: Sequence[OperatingPoint]) -> List[OperatingPoint]:
    """The non-dominated (recall up, time down) frontier, sorted by time."""
    frontier = [p for p in points if not any(q.dominates(p) for q in points)]
    return sorted(frontier, key=lambda p: (p.time_ms, -p.recall))


def tune(index, queries, gt_ids, target_recall: float = 0.9, *, k: Optional[int] = None,
         grid: Optional[Dict[str, Sequence[int]]] = None, reps: int = 2) -> OperatingPoint:
    """The cheapest measured operating point with ``recall >=
    target_recall``; where the grid cannot reach the target, the
    highest-recall point (so the caller always gets something runnable)."""
    points = sweep(index, queries, gt_ids, k=k, grid=grid, reps=reps)
    feasible = [p for p in points if p.recall >= target_recall]
    if feasible:
        return min(feasible, key=lambda p: p.time_ms)
    return max(points, key=lambda p: (p.recall, -p.time_ms))
