"""IVF-PQ — the port of ``vq_tpu.ivf.IVFPQIndex``, the FAISS ``IVFx,PQy``
index: a coarse k-means partition into ``nlist`` lists, and PQ codes of
each vector's residual from its list's centroid.

* :meth:`IVFPQIndex.train` — coarse k-means (``lloyd`` with k-means++
  seeding: K2 each iteration, K1 for the final assignment), then PQ
  codebooks trained on the residuals (K3).
* :meth:`IVFPQIndex.add` — coarse assignment (K1), residual PQ encode
  (K4), and an in-place append to the chunk pool
  (:mod:`vq_tpu_torch.ivf_pool`).
* :meth:`IVFPQIndex.search` — the coarse scan ``||c||^2 - 2 q.c`` (a
  plain fp32 matmul), top-``nprobe`` lists, residual ADC tables per
  (query, probed list), K7 over the probed chunk chains, and a top-k
  merge; with ``rerank=R`` and a kept corpus, a top-R shortlist is
  re-scored exactly. Both top-k steps keep ``jax.lax.top_k``'s order:
  ascending value, the lowest position first on ties (a stable sort).

Values are squared-L2 distances; ids of -1 (values inf) mean the probed
lists held fewer than k rows. Only ``metric="l2"`` is ported:
``metric="dot"`` needs the anisotropic PQ, which has no port yet, and
raises :class:`InvalidParameter`. Not ported yet either:
``range_search``, ``rebalance``, ``remove_ids``, ``merge_from``,
``search_and_reconstruct`` and the ``_search_core`` /
``_reconstruct_core`` forms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.convert import from_state
from vq_tpu_torch.errors import (
    DimensionMismatch,
    EmptyInput,
    InvalidData,
    InvalidParameter,
)
from vq_tpu_torch.ivf_pool import ChunkPool, take_list_ids
from vq_tpu_torch.models.base import _HALF_DTYPES, as_batch_f32, as_tensor, check_training_matrix
from vq_tpu_torch.models.pq import ProductQuantizer, _smallest, pq_train
from vq_tpu_torch.ops.cuda_kernels import ivf_probe_adc_fused
from vq_tpu_torch.ops.kmeans import assign, lloyd
from vq_tpu_torch.utils.serialize import _from_npz, save

__all__ = ["IVFPQIndex"]


def _check_metric(metric: str) -> None:
    if metric not in ("l2", "dot"):
        raise InvalidParameter("metric", "must be 'l2' or 'dot'")
    if metric == "dot":
        raise InvalidParameter(
            "metric", "'dot' (anisotropic PQ) is not ported to vq_tpu_torch yet"
        )


def _probe_tables(q, coarse, cb, nprobe: int, by_residual: bool):
    """The coarse top-``nprobe`` lists ``probe [Q, np]`` of each query and
    the residual ADC tables ``[Q, np, m, kk]`` of each (query, list)."""
    nq = q.shape[0]
    m, _, s = cb.shape
    cc = (coarse * coarse).sum(-1)
    _, probe = _smallest(cc[None, :] - 2.0 * (q @ coarse.T), nprobe)
    if by_residual:
        qres = q[:, None, :] - coarse[probe]
    else:
        qres = q[:, None, :].expand(nq, nprobe, q.shape[1])
    qres = qres.reshape(nq, nprobe, m, s)
    rc = torch.einsum("plms,mks->plmk", qres, cb)
    tables = (qres * qres).sum(-1)[..., None] + (cb * cb).sum(-1)[None, None] - 2.0 * rc
    return probe, tables


def _probe_search(q, coarse, cb, pool_codes, slot_ids, chains_s, nprobe: int,
                  fetch: int, cap: int, by_residual: bool):
    """Probe + residual ADC (K7) + top-``fetch`` -> ``(ids [Q, fetch] i32,
    dist [Q, fetch])``, ascending, dead slots at inf."""
    nq = q.shape[0]
    m, kk, _ = cb.shape
    probe, tables = _probe_tables(q, coarse, cb, nprobe, by_residual)
    ids = take_list_ids(slot_ids, chains_s, probe, cap).reshape(nq, -1)
    dist = ivf_probe_adc_fused(
        tables.reshape(nq * nprobe, m, kk),
        chains_s[probe].reshape(nq * nprobe, -1), pool_codes, cap=cap,
    ).reshape(nq, -1)
    vals, pos = _smallest(torch.where(ids >= 0, dist, float("inf")), fetch)
    return torch.gather(ids, 1, pos), vals


class IVFPQIndex:
    """Inverted-file index with PQ-coded residuals.

    Build with :meth:`train` (coarse k-means + residual PQ from a
    training sample) or from trained parts, then :meth:`add` corpus
    batches and :meth:`search`. Everything lives on the quantizer's
    device.

    ``max_list_size`` caps the searched rows a list: longer lists keep
    their overflow stored (reported by :meth:`bucket_stats`) but
    unsearched."""

    def __init__(
        self,
        coarse_centroids,
        pq: ProductQuantizer,
        *,
        by_residual: bool = True,
        keep_corpus: bool = False,
        max_list_size: Optional[int] = None,
        metric: str = "l2",
    ):
        _check_metric(metric)
        self.metric = metric
        self.pq = pq
        self.coarse = as_tensor(coarse_centroids, pq.device).to(torch.float32).contiguous()
        self.by_residual = bool(by_residual)
        self.keep_corpus = bool(keep_corpus)
        self.max_list_size = max_list_size
        if self.coarse.shape[1] != pq.dim:
            raise DimensionMismatch(expected=pq.dim, found=self.coarse.shape[1])
        self._pool: Optional[ChunkPool] = None
        self._flat_lists: Optional[torch.Tensor] = None  # [n] i32
        self._corpus: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.pq.device

    @property
    def nlist(self) -> int:
        return int(self.coarse.shape[0])

    @property
    def dim(self) -> int:
        return int(self.coarse.shape[1])

    @property
    def ntotal(self) -> int:
        return 0 if self._flat_lists is None else int(self._flat_lists.shape[0])

    def _new_pool(self) -> ChunkPool:
        code_dt = torch.uint8 if self.pq.num_centroids <= 256 else torch.int32
        return ChunkPool(
            {"codes": ((self.pq.num_subspaces,), code_dt)}, self.nlist,
            max_list_size=self.max_list_size, device=self.device,
        )

    def _pool_append(self, lists: torch.Tensor, codes: torch.Tensor) -> None:
        if self._pool is None:
            self._pool = self._new_pool()
        self._pool.append(lists, {"codes": codes})
        self._flat_lists = (
            lists if self._flat_lists is None else torch.cat([self._flat_lists, lists])
        )

    def reserve(self, rows: int) -> None:
        """Preallocate code storage for ``rows`` total vectors."""
        if self._pool is None:
            self._pool = self._new_pool()
        self._pool.reserve(int(rows))

    # -- construction -------------------------------------------------------

    @classmethod
    def train(
        cls,
        training_data,
        nlist: int,
        num_subspaces: int,
        num_centroids: int = 256,
        *,
        max_iters: int = 10,
        seed: int = 42,
        by_residual: Optional[bool] = None,
        keep_corpus: bool = False,
        metric: str = "l2",
        spherical: bool = False,
        device=None,
    ) -> "IVFPQIndex":
        """Fit the coarse quantizer (k-means++ seeded Lloyd, ``seed``) and
        the PQ codebooks on the residuals (``seed + 1``), on the training
        data's device (``device`` moves non-tensor input there)."""
        _check_metric(metric)
        by_residual = True if by_residual is None else bool(by_residual)
        x = check_training_matrix(training_data, device)
        res = lloyd(x, nlist, max_iters=max_iters, seed=seed, init="kmeans++",
                    spherical=spherical)
        train_vecs = x - res.centroids[res.assignments.to(torch.int64)] if by_residual else x
        cb = pq_train(train_vecs, num_subspaces, num_centroids, max_iters=max_iters,
                      seed=seed + 1)
        pq = ProductQuantizer(codebooks=cb, distance="squared_euclidean")
        return cls(res.centroids, pq, by_residual=by_residual, keep_corpus=keep_corpus)

    # -- data ---------------------------------------------------------------

    def add(self, vectors) -> None:
        """Coarse-assign (K1), residual-encode (K4) and append a batch.
        f16/bf16 batches keep a half kept corpus; residuals are f32."""
        x = as_tensor(vectors, self.device)
        if x.dtype not in _HALF_DTYPES:
            x = x.to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.pq.dim:
            raise DimensionMismatch(expected=self.pq.dim, found=x.shape[1])
        lists, _ = assign(x, self.coarse)
        enc_in = x - self.coarse[lists.to(torch.int64)] if self.by_residual else x
        self._pool_append(lists, self.pq.encode(enc_in))
        if self.keep_corpus:
            self._corpus = x if self._corpus is None else torch.cat([self._corpus, x])

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded vectors for stored ids: PQ decode of the residual plus
        the coarse centroid when ``by_residual``."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        pos = as_tensor(ids, self.device).to(torch.int64)
        rec = self.pq.decode(self._pool.gather_rows("codes", pos))
        if self.by_residual:
            rec = rec + self.coarse[self._flat_lists[pos].to(torch.int64)]
        return rec

    def bucket_stats(self) -> dict:
        """Occupancy: list-size distribution, searched capacity, and how
        many rows a ``max_list_size`` cap leaves unsearched."""
        if self._flat_lists is None:
            return {"ntotal": 0}
        counts = self._pool.lens_h
        cap = self._pool.cap
        return {
            "ntotal": int(self.ntotal),
            "nlist": self.nlist,
            "cap": cap,
            "min": int(counts.min()),
            "mean": float(counts.mean()),
            "max": int(counts.max()),
            "empty_lists": int((counts == 0).sum()),
            "overflow_dropped": int(np.maximum(counts - cap, 0).sum()),
            "padding_waste": float(
                1.0 - int(np.minimum(counts, cap).sum()) / (self.nlist * cap)
            ),
            **self._pool.stats(),
        }

    # -- search -------------------------------------------------------------

    def search(self, queries, k: int = 10, *, nprobe: int = 8,
               rerank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [Q, k] i32, squared-L2 values [Q, k])`` over
        ``nprobe`` lists a query, ascending; -1 / inf pad when the probed
        lists hold fewer than k rows. ``rerank=R`` (with
        ``keep_corpus=True``) re-scores a top-R shortlist exactly."""
        q, _ = as_batch_f32(queries, self.device)
        if q.shape[1] != self.pq.dim:
            raise DimensionMismatch(expected=self.pq.dim, found=q.shape[1])
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty — add() vectors first")
        k, rerank = int(k), int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData("rerank requires keep_corpus=True at construction")
        pool = self._pool
        chains_s = pool.chains_search()
        nprobe = min(int(nprobe), self.nlist)
        fetch = max(k, rerank) if rerank else k
        width = nprobe * chains_s.shape[1] * pool.ch  # rows a search can see
        ids, dist = _probe_search(
            q, self.coarse, self.pq.codebooks, pool.data["codes"], pool.slot_ids,
            chains_s, nprobe, min(fetch, width), pool.cap, self.by_residual,
        )
        if rerank:
            cand = self._corpus[ids.clamp_min(0).to(torch.int64)].to(torch.float32)
            exact = ((cand - q[:, None, :]) ** 2).sum(-1)
            exact = torch.where(ids >= 0, exact, float("inf"))
            dist, pos = _smallest(exact, min(k, exact.shape[1]))
            ids = torch.gather(ids, 1, pos)
        else:
            ids, dist = ids[:, :k], dist[:, :k]
        ids = torch.where(torch.isinf(dist), -1, ids)
        if ids.shape[1] < k:  # fewer rows probed than k: pad the contract
            pad = k - ids.shape[1]
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            dist = torch.nn.functional.pad(dist, (0, pad), value=float("inf"))
        return ids, dist

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the index as an ``ivfpq_index`` ``.npz`` (the JAX
        package's format); returns the path."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "IVFPQIndex":
        """Load an ``ivfpq_index`` saved by either package onto ``device``."""
        kind, config, arrays = _from_npz(path)
        if kind != "ivfpq_index":
            raise InvalidData(f"expected an ivfpq_index checkpoint, got {kind!r}")
        return from_state(kind, config, arrays, device=device)

    def __repr__(self) -> str:
        return (
            f"IVFPQIndex(nlist={self.nlist}, ntotal={self.ntotal}, "
            f"m={self.pq.num_subspaces}, k={self.pq.num_centroids}, "
            f"residual={self.by_residual}, metric={self.metric!r})"
        )
