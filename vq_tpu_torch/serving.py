"""Multi-batch serving — the port of ``vq_tpu.serving``.

Every index gives its search as ``_search_core(k, **params) -> (fn,
arrays)``, the same code :meth:`search` runs. :class:`BatchPipeline`
takes the core once and runs its ``fn`` over ``T`` query batches of a
``[T, Q, d]`` tensor on the card, one batch after another with no host
sync of its own between them, and stacks the outputs: the JAX package's
``lax.scan`` under one ``jit`` becomes a loop of launches. Each batch's
ids and values are bit-identical to one ``search`` call on it.

A pipeline holds the index's storage as it was when it was built. The
port's IVF indexes keep their lists in a chunk pool that ``rebalance``,
``remove_ids`` and ``merge_from`` change in place, so a stale pipeline
would read relabelled chains. It therefore raises :class:`InvalidData`
when ``ntotal`` or the base's ``ChunkPool`` (its object or its
``version``, through a ``TransformedIndex``, ``RefineIndex`` or
``IdMapIndex`` wrapper too) has changed since it was built. The JAX
package checks ``ntotal`` alone: after a ``rebalance`` its pipeline
fails inside XLA on the pool's donated buffers instead (``ROADMAP.md``,
R11).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor

__all__ = ["BatchPipeline", "pipelined_search"]


def _pool_of(index):
    """``(holder, pool)``: the innermost base under any wrapper and its
    chunk pool (``None`` for a flat index)."""
    inner = index
    while hasattr(inner, "base"):
        inner = inner.base
    return inner, getattr(inner, "_pool", None)


class BatchPipeline:
    """Pipelined serving over an index::

        pipe = BatchPipeline(index, k=10, nprobe=8)
        ids, vals = pipe.search(batches)   # [T, Q, d] -> [T, Q, k] x2

    Build a new pipeline after ``add`` / ``remove_ids`` / ``merge_from`` /
    ``rebalance``: searching a stale one raises."""

    def __init__(self, index, k: int = 10, **search_params):
        core_maker = getattr(index, "_search_core", None)
        if core_maker is None:
            raise InvalidParameter(
                "index", f"{type(index).__name__} does not support pipelined serving "
                "(no _search_core)")
        self.index = index
        self.k = int(k)
        self.params = dict(search_params)
        core, arrays = core_maker(self.k, **self.params)
        holder, pool = _pool_of(index)
        self._wire(core, arrays, ntotal=index.ntotal, dim=getattr(index, "dim", None),
                   device=getattr(index, "device", None))
        self._holder, self._pool = holder, pool
        self._version = None if pool is None else pool.version

    @classmethod
    def from_core(cls, core, arrays, *, dim: Optional[int] = None):
        """A pipeline over an explicit ``(fn, arrays)`` search core. No
        staleness check (there is no index to watch): rebuild it after the
        storage changes."""
        self = cls.__new__(cls)
        self.index = None
        self.k = None
        self.params = {}
        arrays = tuple(arrays)
        device = next((a.device for a in arrays if isinstance(a, torch.Tensor)), None)
        self._wire(core, arrays, ntotal=None, dim=dim, device=device)
        self._holder = self._pool = self._version = None
        return self

    def _wire(self, core, arrays, *, ntotal, dim, device):
        self._core = core
        self._arrays = tuple(arrays)
        self._ntotal = ntotal
        self._dim = dim
        self._device = device

    def _check_fresh(self) -> None:
        if self.index is None:
            return
        pool = getattr(self._holder, "_pool", None)
        if self.index.ntotal != self._ntotal or pool is not self._pool or (
            pool is not None and pool.version != self._version
        ):
            raise InvalidData(
                "index contents changed since this BatchPipeline was built — construct a new one")

    def search(self, query_batches) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every batch through the core -> ``(ids [T, Q, k], values
        [T, Q, k])``. ``query_batches`` is ``[T, Q, d]`` (or a list of
        equal ``[Q, d]`` arrays)."""
        self._check_fresh()
        if isinstance(query_batches, (list, tuple)) and query_batches and isinstance(
                query_batches[0], torch.Tensor):
            query_batches = torch.stack(list(query_batches))
        qs = as_tensor(query_batches, self._device).to(torch.float32)
        if qs.ndim != 3:
            raise InvalidParameter("query_batches", f"expected [T, Q, d], got {qs.ndim}-D")
        if self._dim is not None and qs.shape[-1] != self._dim:
            raise DimensionMismatch(expected=self._dim, found=qs.shape[-1])
        outs = [self._core(qs[t], *self._arrays) for t in range(qs.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def pipelined_search(index, queries, k: int = 10, *, batch: int = 128,
                     pipeline: Optional[BatchPipeline] = None,
                     **search_params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a large query set ``[N, d]`` in batches of ``batch`` rows
    (the last padded with its first row) through one pipeline ->
    ``(ids [N, k], values [N, k])``. Pass a built ``pipeline`` to reuse
    it across calls; otherwise one is built from ``k`` and
    ``search_params``."""
    device = getattr(index, "device", None) if pipeline is None else pipeline._device
    q = as_tensor(queries, device).to(torch.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2:
        raise InvalidParameter("queries", f"expected [N, d], got {q.ndim}-D")
    n, d = q.shape
    if n == 0:
        raise InvalidParameter("queries", "empty query set")
    batch = max(1, min(int(batch), n))
    if pipeline is None:
        pipeline = BatchPipeline(index, k=k, **search_params)
    pad = (-n) % batch
    if pad:
        q = torch.cat([q, q[:1].expand(pad, d)])
    ids, vals = pipeline.search(q.reshape(-1, batch, d))
    kk = ids.shape[-1]
    return ids.reshape(-1, kk)[:n], vals.reshape(-1, kk)[:n]
