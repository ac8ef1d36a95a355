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

* :meth:`IVFPQIndex.range_search` — the search's probe (K7, the same
  tables and offset), then every live slot within the radius, the best
  ``max_results`` of them in one stable sort, with the true hit counts.
* :meth:`IVFPQIndex.remove_ids`, :meth:`IVFPQIndex.merge_from` and
  :meth:`IVFPQIndex.rebalance` — the chunk pool's maintenance, as in
  :mod:`vq_tpu_torch.ivf_flat`; a rebalance re-encodes each moved row
  against its new centroid (K4), from the kept corpus or else from its
  decoded row and its old centroid.

Values are squared-L2 distances (ascending, -1 / inf padding) or, for
``metric="dot"``, inner-product scores (descending, -1 / -inf padding).
``_search_core`` and ``_reconstruct_core`` give a search and a
reconstruct as ``(fn, arrays)``.
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
from vq_tpu_torch.ivf_flat import (
    _coarse_probe,
    _default_target,
    _move_rows,
    _pad_to_k,
    _range_hits,
    _rebalance_pass,
    _rebalance_rounds,
)
from vq_tpu_torch.ivf_pool import ChunkPool, bucket_stats, take_list_ids
from vq_tpu_torch.models.base import _HALF_DTYPES, as_batch_f32, as_tensor, check_training_matrix
from vq_tpu_torch.models.pq import ProductQuantizer, _smallest, pq_train
from vq_tpu_torch.models.pq_anisotropic import AnisotropicProductQuantizer, pq_train_anisotropic
from vq_tpu_torch.ops.cuda_kernels import ivf_probe_adc_fused
from vq_tpu_torch.ops.kmeans import assign, lloyd
from vq_tpu_torch.search import (
    _compact_rows,
    _merge_check,
    _merge_corpus,
    _removal_keep_mask,
    _search_and_reconstruct,
)
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


def _probe_dists(q, coarse, cb, pool_codes, slot_ids, chains_s, nprobe: int, cap: int,
                 by_residual: bool, metric: str = "l2"):
    """Probe + ADC sums (K7) -> ``(ids [Q, nprobe * rows] i32, dist [Q,
    nprobe * rows])``, probe-rank major, smaller is better (negated
    scores for dot, ``q.c_probe`` subtracted for dot over residuals),
    dead slots -1 / inf: the step :meth:`IVFPQIndex.search` and
    :meth:`IVFPQIndex.range_search` share."""
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
    return ids, torch.where(ids >= 0, dist.reshape(nq, -1), float("inf"))


def _topk(ids, dist, fetch: int):
    """The best ``fetch`` of a probe's ``(ids, dist)`` in one stable sort
    (``jax.lax.top_k``'s order)."""
    vals, pos = _smallest(dist, fetch)
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
        lists = lists.to(device=self.device, dtype=torch.int32)
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
        fn, arrays = self._reconstruct_core()
        return fn(ids, *arrays)

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
        q = self._check_query(queries)
        fn, arrays = self._search_core(int(k), nprobe=nprobe, rerank=rerank)
        return fn(q, *arrays)

    def _check_query(self, queries) -> torch.Tensor:
        q, _ = as_batch_f32(queries, self.device)
        if q.shape[1] != self.pq.dim:
            raise DimensionMismatch(expected=self.pq.dim, found=q.shape[1])
        return q

    def _check_nonempty(self) -> None:
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty — add() vectors first")

    def _search_core(self, k: int, *, nprobe: int = 8, rerank: int = 0):
        """The search as ``(fn, arrays)``: ``fn(q, coarse, codebooks, codes,
        slot_ids, chains[, corpus])`` with f32 queries ``q [Q, d]`` is
        :meth:`search`."""
        self._check_nonempty()
        k, rerank = int(k), int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData("rerank requires keep_corpus=True at construction")
        pool = self._pool
        chains_s, cap = pool.chains_search(), pool.cap
        nprobe = min(int(nprobe), self.nlist)
        fetch = max(k, rerank) if rerank else k
        fetch = min(fetch, nprobe * chains_s.shape[1] * pool.ch)  # rows a search can see
        metric, by_residual = self.metric, self.by_residual
        arrays = (self.coarse, self.pq.codebooks, pool.data["codes"], pool.slot_ids,
                  chains_s) + ((self._corpus,) if rerank else ())

        def fn(q, coarse, cbs, codes, slot_ids, chains, *rest):
            ids, dist = _topk(*_probe_dists(q, coarse, cbs, codes, slot_ids, chains, nprobe, cap,
                                            by_residual, metric), fetch)
            if rerank:  # smaller is better here: dot scores negated
                cand = rest[0][ids.clamp_min(0).to(torch.int64)].to(torch.float32)
                if metric == "dot":
                    exact = -(cand * q[:, None, :]).sum(-1)
                else:
                    exact = ((cand - q[:, None, :]) ** 2).sum(-1)
                exact = torch.where(ids >= 0, exact, float("inf"))
                dist, pos = _smallest(exact, min(k, exact.shape[1]))
                ids = torch.gather(ids, 1, pos)
            else:
                ids, dist = ids[:, :k], dist[:, :k]
            ids, dist = _pad_to_k(ids, dist, k)
            return (ids, -dist) if metric == "dot" else (ids, dist)

        return fn, arrays

    def range_search(self, queries, radius: float, *, nprobe: int = 8,
                     max_results: int = 1024) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every probed row whose ADC value is within ``radius`` (faiss's
        IVF contract: recall bounded by the probe set; values are the
        asymmetric PQ approximations) -> ``(ids, values, counts)``: the best
        ``max_results`` hits (-1 / inf pads, -inf scores for ``dot``) and
        the true number of probed hits a query. A hit is ``value <=
        radius`` for L2 and ``score >= radius`` for dot. The probe is the
        search's: K7 over the probed chains."""
        if int(max_results) < 1:
            raise InvalidParameter("max_results", "must be >= 1")
        self._check_nonempty()
        q = self._check_query(queries)
        pool = self._pool
        chains_s = pool.chains_search()
        nprobe = min(int(nprobe), self.nlist)
        fetch = min(int(max_results), nprobe * chains_s.shape[1] * pool.ch)
        ids, dist = _probe_dists(q, self.coarse, self.pq.codebooks, pool.data["codes"],
                                 pool.slot_ids, chains_s, nprobe, pool.cap, self.by_residual,
                                 self.metric)
        return _range_hits(ids, dist, float(radius), fetch, int(max_results), self.metric == "dot")

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the decoded vector of every hit -> ``(ids, values,
        vectors [Q, k, d])``; padded -1 ids give zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    def _reconstruct_core(self):
        """:meth:`reconstruct` as ``(fn, arrays)``: ``fn(ids [N], codes_pool,
        pos, lists, coarse) -> [N, d]`` f32, the pool's codes and id -> slot
        map, the list of every row and the coarse centroids as the
        arguments."""
        self._check_nonempty()
        pq, by_residual, m = self.pq, self.by_residual, self.pq.num_subspaces

        def fn(ids, codes_pool, pos, lists, coarse):
            ids = as_tensor(ids, codes_pool.device).to(torch.int64)
            rec = pq.decode(codes_pool.reshape(-1, m)[pos[ids].to(torch.int64)])
            if by_residual:
                rec = rec + coarse[lists[ids].to(torch.int64)]
            return rec

        pool = self._pool
        return fn, (pool.data["codes"], pool.pos, self._flat_lists, self.coarse)

    # -- lifecycle ----------------------------------------------------------

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; the rest renumber
        sequentially (faiss's ``remove_ids`` contract), a kept corpus with
        them. Only the lists that held removed rows repack. Returns the
        count removed."""
        if self._flat_lists is None:
            raise EmptyInput("index is empty")
        mask = _removal_keep_mask(ids, self.ntotal, self.device)
        removed = np.where(~mask.cpu().numpy())[0]
        lists_np = self._flat_lists.cpu().numpy()
        self._flat_lists, self._corpus = _compact_rows(mask, self._flat_lists, self._corpus)
        self._pool.remove(removed, lists_np)
        return int(removed.size)

    def merge_from(self, other: "IVFPQIndex") -> int:
        """Move every vector of ``other`` into this index (faiss IVF
        ``merge_from``): the same metric, coding, coarse centroids and PQ
        codebooks; the codes copied, never re-encoded, a kept corpus
        carried along, ``other`` left empty. Returns the count moved."""
        _merge_check(self, other, attrs=("metric", "by_residual"),
                     arrays=(("coarse centroids", "coarse"), ("PQ codebooks", "pq.codebooks")))
        moved = other.ntotal
        _merge_corpus(self, other)
        if moved:
            self._pool_append(other._flat_lists, other._pool.to_flat()["codes"])
        other._pool = other._flat_lists = other._corpus = None
        return moved

    def rebalance(self, *, target_max: Optional[int] = None, min_size: int = 0,
                  max_iters: int = 8, seed: int = 0, rounds: int = 3) -> dict:
        """Split overfull lists and retire underfull ones, as
        :meth:`vq_tpu_torch.IVFFlatIndex.rebalance` does: lists longer than
        ``target_max`` (default ``max_list_size``, else twice the mean list
        size) split by k-means on a member subsample, lists shorter than
        ``min_size`` retire, and every affected row is reassigned (K1) and
        re-encoded against its new centroid (K4) — exactly from a kept
        corpus, else from its decoded row. Up to ``rounds`` passes.
        Returns ``{"split", "retired", "new_nlist"}``."""
        if self._flat_lists is None:
            raise EmptyInput("index is empty — add() vectors first")
        split, retired = _rebalance_rounds(self._rebalance_once, target_max, min_size,
                                           max_iters, seed, rounds)
        return {"split": split, "retired": retired, "new_nlist": self.nlist}

    def _rebalance_once(self, *, target_max, min_size, max_iters, seed) -> dict:
        lists_np = self._flat_lists.cpu().numpy()
        counts = np.bincount(lists_np, minlength=self.nlist)
        old_coarse, old_lists, pool, dev = self.coarse, self._flat_lists, self._pool, self.device

        def member_vectors(rows: np.ndarray) -> torch.Tensor:
            idx = torch.as_tensor(rows, device=dev).to(torch.int64)
            if self._corpus is not None:
                return self._corpus[idx].to(torch.float32)
            rec = self.pq.decode(pool.gather_rows("codes", idx))  # the old centroid added back
            return rec + old_coarse[old_lists[idx].to(torch.int64)] if self.by_residual else rec

        out = _rebalance_pass(
            lists_np, old_coarse.cpu().numpy(), self.nlist, member_vectors,
            target_max=target_max, default_target=_default_target(self.max_list_size, counts),
            min_size=min_size, max_iters=max_iters, seed=seed,
        )
        if out is None:
            return {"split": 0, "retired": 0, "new_nlist": self.nlist}
        coarse_new = torch.as_tensor(out["coarse_new"], device=dev).contiguous()

        def block_payloads(rb, nlb):
            xb = member_vectors(rb)
            if self.by_residual:
                xb = xb - coarse_new[torch.as_tensor(nlb, device=dev).to(torch.int64)]
            return {"codes": self.pq.encode(xb)}

        _move_rows(pool, out, lists_np, block_payloads)
        self.coarse = coarse_new
        self._flat_lists = torch.as_tensor(out["lists"].astype(np.int32), device=dev)
        return {"split": out["split"], "retired": out["retired"], "new_nlist": self.nlist}

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
