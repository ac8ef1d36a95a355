"""IVF-PQ — the port of ``vq_tpu.ivf.IVFPQIndex``, the FAISS ``IVFx,PQy``
index: a coarse k-means partition into ``nlist`` lists, and PQ codes of
each vector (or of its residual from its list's centroid).

* :meth:`IVFPQIndex.train` — coarse k-means (``lloyd`` with k-means++
  seeding: K2 each iteration, K1 for the final assignment), then PQ
  codebooks (K3): on the residuals for ``metric="l2"``; for
  ``metric="dot"`` (maximum inner product) by default an anisotropic
  (score-aware) PQ on the raw rows (:mod:`vq_tpu_torch.models.pq_anisotropic`:
  K3, then the exact codebook refinement), or, with ``by_residual=True``,
  plain PQ on the residuals.
* :meth:`IVFPQIndex.add` — coarse assignment (K1), PQ encode of the
  residual or row (K4; the anisotropic PQ's coordinate descent after it)
  and an in-place append to the chunk pool (:mod:`vq_tpu_torch.ivf_pool`).
* :meth:`IVFPQIndex.search` — the coarse scan (a plain fp32 matmul: the
  smallest ``||c||^2 - 2 q.c`` for L2, the largest ``q.c`` for dot),
  top-``nprobe`` lists, ADC tables per (query, probed list), K7 over the
  probed chunk chains, and a top-k merge; with ``rerank=R`` and a kept
  corpus, a top-R shortlist is re-scored exactly. L2 tables hold the
  residual's squared distances; dot tables are the negated per-query
  dots ``-q_i . c`` (the same table for every probed list), with the
  offset ``-q.c_probe`` added after K7 when the codes are residuals.
  Both top-k steps keep ``jax.lax.top_k``'s order on the negated scores:
  ascending value, the lowest position first on ties (a stable sort);
  -0.0 equals +0.0 and NaN never wins, where the reference's top-k ranks
  +0.0 above -0.0 and lets a NaN score win (``ROADMAP.md``, R8).

Values are squared-L2 distances (ascending, -1 / inf padding) or, for
``metric="dot"``, inner-product scores (descending, -1 / -inf padding).
Not ported yet: ``range_search``, ``rebalance``, ``remove_ids``,
``merge_from``, ``search_and_reconstruct`` and the ``_search_core`` /
``_reconstruct_core`` forms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vq_tpu_torch.convert import from_state
from vq_tpu_torch.errors import (
    DimensionMismatch,
    EmptyInput,
    InvalidData,
    InvalidParameter,
)
from vq_tpu_torch.ivf_flat import _coarse_probe, _pad_to_k
from vq_tpu_torch.ivf_pool import ChunkPool, bucket_stats, take_list_ids
from vq_tpu_torch.models.base import _HALF_DTYPES, as_batch_f32, as_tensor, check_training_matrix
from vq_tpu_torch.models.pq import ProductQuantizer, _smallest, pq_train
from vq_tpu_torch.models.pq_anisotropic import AnisotropicProductQuantizer, pq_train_anisotropic
from vq_tpu_torch.ops.cuda_kernels import ivf_probe_adc_fused
from vq_tpu_torch.ops.kmeans import assign, lloyd
from vq_tpu_torch.utils.serialize import _from_npz, save

__all__ = ["IVFPQIndex"]


def _check_metric(metric: str) -> None:
    if metric not in ("l2", "dot"):
        raise InvalidParameter("metric", "must be 'l2' or 'dot'")


def _probe_tables(q, coarse, cb, nprobe: int, by_residual: bool, metric: str = "l2"):
    """The coarse top-``nprobe`` lists ``probe [Q, np]`` of each query, the
    ADC tables ``[Q, np, m, kk]`` of each (query, list) and ``q.c_probe
    [Q, np]``, the offset to subtract after the table sums (None unless
    dot over residual codes): L2 tables from the residual (or the query
    itself), dot tables ``-q_i . c``."""
    nq = q.shape[0]
    m, kk, s = cb.shape
    probe, qc = _coarse_probe(q, coarse, nprobe, metric)
    if metric == "dot":
        t = torch.einsum("qms,mks->qmk", q.reshape(nq, m, s), cb)
        tables = (-t)[:, None].expand(nq, nprobe, m, kk)
        return probe, tables, torch.gather(qc, 1, probe) if by_residual else None
    if by_residual:
        qres = q[:, None, :] - coarse[probe]
    else:
        qres = q[:, None, :].expand(nq, nprobe, q.shape[1])
    qres = qres.reshape(nq, nprobe, m, s)
    rc = torch.einsum("plms,mks->plmk", qres, cb)
    tables = (qres * qres).sum(-1)[..., None] + (cb * cb).sum(-1)[None, None] - 2.0 * rc
    return probe, tables, None


def _probe_search(q, coarse, cb, pool_codes, slot_ids, chains_s, nprobe: int,
                  fetch: int, cap: int, by_residual: bool, metric: str = "l2"):
    """Probe + ADC (K7) + top-``fetch`` -> ``(ids [Q, fetch] i32, dist [Q,
    fetch])``, ascending (negated scores for dot), dead slots at inf."""
    nq = q.shape[0]
    m, kk, _ = cb.shape
    probe, tables, qc_probe = _probe_tables(q, coarse, cb, nprobe, by_residual, metric)
    ids = take_list_ids(slot_ids, chains_s, probe, cap).reshape(nq, -1)
    dist = ivf_probe_adc_fused(
        tables.reshape(nq * nprobe, m, kk),
        chains_s[probe].reshape(nq * nprobe, -1), pool_codes, cap=cap,
    ).reshape(nq, nprobe, -1)
    if qc_probe is not None:
        dist = dist - qc_probe[:, :, None]
    dist = dist.reshape(nq, -1)
    vals, pos = _smallest(torch.where(ids >= 0, dist, float("inf")), fetch)
    return torch.gather(ids, 1, pos), vals


class IVFPQIndex:
    """Inverted-file index with PQ codes of residuals (or of the rows).

    Build with :meth:`train` (coarse k-means + PQ from a training sample)
    or from trained parts, then :meth:`add` corpus
    batches and :meth:`search`. Everything lives on the quantizer's
    device.

    ``max_list_size`` caps the searched rows a list: longer lists keep
    their overflow stored (reported by :meth:`bucket_stats`) but
    unsearched. ``metric="dot"`` makes :meth:`search` a maximum-inner-product
    search (descending scores, ``-inf`` padding); pass an
    :class:`~vq_tpu_torch.models.pq_anisotropic.AnisotropicProductQuantizer`
    as ``pq`` (or :meth:`train` with ``metric="dot"``) for score-aware
    codes."""

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
        anisotropic_threshold: float = 0.2,
        refine_iters: int = 5,
        spherical: bool = False,
        device=None,
    ) -> "IVFPQIndex":
        """Fit the coarse quantizer (k-means++ seeded Lloyd, ``seed``) and
        the PQ codebooks (``seed + 1``), on the training data's device
        (``device`` moves non-tensor input there).

        ``by_residual`` defaults to ``metric == "l2"``. With
        ``metric="dot"`` and raw-row codes the PQ is anisotropic (score
        threshold ``anisotropic_threshold``, ``refine_iters`` rounds of
        its exact refinement): its loss needs each row's own direction.
        Otherwise plain PQ trains on the residuals or rows."""
        _check_metric(metric)
        by_residual = metric == "l2" if by_residual is None else bool(by_residual)
        x = check_training_matrix(training_data, device)
        res = lloyd(x, nlist, max_iters=max_iters, seed=seed, init="kmeans++",
                    spherical=spherical)
        train_vecs = x - res.centroids[res.assignments.to(torch.int64)] if by_residual else x
        if metric == "dot" and not by_residual:
            cb = pq_train_anisotropic(train_vecs, num_subspaces, num_centroids,
                                      max_iters=max_iters, seed=seed + 1,
                                      threshold=anisotropic_threshold, refine_iters=refine_iters)
            pq = AnisotropicProductQuantizer(codebooks=cb, threshold=anisotropic_threshold)
        else:
            cb = pq_train(train_vecs, num_subspaces, num_centroids, max_iters=max_iters,
                          seed=seed + 1)
            pq = ProductQuantizer(codebooks=cb, distance="squared_euclidean")
        return cls(res.centroids, pq, by_residual=by_residual, keep_corpus=keep_corpus,
                   metric=metric)

    # -- data ---------------------------------------------------------------

    def add(self, vectors) -> None:
        """Coarse-assign (K1), encode the residual or row (K4) and append a
        batch. f16/bf16 batches keep a half kept corpus; residuals are f32."""
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
        return bucket_stats(self._pool, self.ntotal)

    # -- search -------------------------------------------------------------

    def search(self, queries, k: int = 10, *, nprobe: int = 8,
               rerank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [Q, k] i32, values [Q, k])`` over ``nprobe`` lists a
        query: squared-L2 distances ascending (-1 / inf padding) or, for
        ``metric="dot"``, inner-product scores descending (-1 / -inf
        padding) when the probed lists hold fewer than k rows.
        ``rerank=R`` (with ``keep_corpus=True``) re-scores a top-R
        shortlist exactly under the index's metric."""
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
            chains_s, nprobe, min(fetch, width), pool.cap, self.by_residual, self.metric,
        )
        if rerank:  # smaller is better here: dot scores negated
            cand = self._corpus[ids.clamp_min(0).to(torch.int64)].to(torch.float32)
            if self.metric == "dot":
                exact = -(cand * q[:, None, :]).sum(-1)
            else:
                exact = ((cand - q[:, None, :]) ** 2).sum(-1)
            exact = torch.where(ids >= 0, exact, float("inf"))
            dist, pos = _smallest(exact, min(k, exact.shape[1]))
            ids = torch.gather(ids, 1, pos)
        else:
            ids, dist = ids[:, :k], dist[:, :k]
        ids, dist = _pad_to_k(ids, dist, k)
        return (ids, -dist) if self.metric == "dot" else (ids, dist)

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
