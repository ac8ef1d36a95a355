"""Flat ADC search over PQ and RQ codes — the ``PQIndex`` and ``RQIndex``
of ``vq_tpu.search``.

``PQIndex.add`` encodes a batch (K4 on the card) and appends its codes;
``search`` is the flat ADC top-k (K5 on the card) with an optional exact
rerank from the kept raw corpus.

``RQIndex`` stores ``[n, S]`` stage codes and each row's exact decoded
squared norm (additive codes have cross-stage norm terms that per-stage
tables cannot express, as in faiss's ``IndexResidualQuantizer``). Its
search builds per-stage dot tables ``T[q, s, j] = q.C_s[j]`` and takes
one of two routes, which return the same ids and values:

* K5 in mode ``"l2"`` (``max(||q||^2 - 2 sum T + ||y||^2, 0)``) or
  ``"dot"`` (``-sum T``) plus one stable merge, when k <= 256, the metric
  is squared-L2, L2 or dot, ``1 <= fetch <= 128`` and ``fetch < n`` (the
  JAX package also gates on the TPU backend, its VMEM budget and ``n >
  32768``; those gates are not ported);
* otherwise the chunked scan of ``_rq_scan_jit``: K8 sums the tables over
  a chunk of codes, the metric is assembled elementwise, and a running
  top-``fetch`` merges the chunks (cosine and ``fetch > 128`` take it).

Both top-k steps keep ``jax.lax.top_k``'s order: ascending, the lowest
position first on ties (stable sorts). Codes, norms and corpus live on
the quantizer's device. ``range_search``, ``search_and_reconstruct`` and
``_search_core`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vq_tpu_torch.errors import (
    DimensionMismatch,
    EmptyInput,
    InvalidData,
    InvalidParameter,
)
from vq_tpu_torch.convert import from_state
from vq_tpu_torch.models.base import _HALF_DTYPES, as_tensor
from vq_tpu_torch.models.pq import ProductQuantizer, _adc_lookup, _merge_candidates, _smallest
from vq_tpu_torch.models.rq import ResidualQuantizer
from vq_tpu_torch.ops.cuda_kernels import adc_scan_topk_fused
from vq_tpu_torch.ops.distance import COSINE_NORM_EPS, _PAIRWISE, Metric
from vq_tpu_torch.ops.packing import bits_for, pack_codes, unpack_codes
from vq_tpu_torch.utils.serialize import _from_npz, save

__all__ = ["PQIndex", "RQIndex"]

_RQ_METRICS = ("squared_euclidean", "euclidean", "cosine", "dot")


def _removal_keep_mask(ids, ntotal: int, device) -> torch.Tensor:
    """Boolean keep-mask for ``remove_ids``: validates, dedups, and
    rejects out-of-range positions."""
    ids = torch.atleast_1d(as_tensor(ids, device).to(torch.int64))
    if ids.ndim != 1:
        raise InvalidParameter("ids", "expected a 1-D array of positions")
    if ids.numel() and bool(((ids < 0) | (ids >= ntotal)).any()):
        raise InvalidParameter("ids", f"positions must be in [0, {ntotal})")
    keep = torch.ones((ntotal,), dtype=torch.bool, device=device)
    keep[ids] = False
    return keep


def _concat_rows(a, b):
    if b is None:
        return a
    return b if a is None else torch.cat([a, b], dim=0)


class PQIndex:
    """Flat ADC index over PQ codes.

    ``keep_corpus=True`` keeps the raw vectors to enable exact reranking:
    ``search(..., rerank=R)`` re-scores a top-R ADC shortlist with exact
    distances under the quantizer's metric. ``packed=True`` stores codes
    sub-byte packed (4 bits a code at k <= 16); ``packed=None`` packs
    whenever k <= 16.
    """

    def __init__(self, quantizer: ProductQuantizer, *, keep_corpus: bool = False,
                 packed: Optional[bool] = None):
        self.pq = quantizer
        self.keep_corpus = keep_corpus
        min_bits = bits_for(quantizer.num_centroids)
        if packed is None:
            packed = min_bits < 8
        if packed and min_bits >= 8:
            raise InvalidParameter(
                "packed", "sub-byte packing requires k <= 16 centroids"
            )
        self.pack_bits = min_bits if packed else 8
        self._codes: Optional[torch.Tensor] = None  # [n, m] ([n, B] packed)
        self._corpus: Optional[torch.Tensor] = None  # [n, d] if kept

    @property
    def device(self) -> torch.device:
        return self.pq.device

    @property
    def dim(self) -> int:
        return self.pq.dim

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else int(self._codes.shape[0])

    @property
    def code_bytes_per_vector(self) -> int:
        if self.pack_bits < 8:
            return -(-self.pq.num_subspaces * self.pack_bits // 8)
        itemsize = 1 if self.pq.num_centroids <= 256 else 4
        return self.pq.num_subspaces * itemsize

    def add(self, vectors, *, precision: str = "highest") -> None:
        """Encode and append a batch of raw vectors. f16/bf16 batches stay
        half: encode upcasts in registers and a kept corpus stays half."""
        x = as_tensor(vectors, self.device)
        if x.dtype not in _HALF_DTYPES:
            x = x.to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.pq.dim:
            raise DimensionMismatch(expected=self.pq.dim, found=x.shape[1])
        codes = self.pq.encode(x, precision=precision)
        if self.pack_bits < 8:
            codes = pack_codes(codes, self.pack_bits)
        self._codes = _concat_rows(self._codes, codes)
        if self.keep_corpus:
            self._corpus = _concat_rows(self._corpus, x)

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; returns the number removed.
        The rest renumber sequentially (faiss's flat-index contract)."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        keep = _removal_keep_mask(ids, self.ntotal, self._codes.device)
        removed = self.ntotal - int(keep.sum())
        self._codes = self._codes[keep]
        if self._corpus is not None:
            self._corpus = self._corpus[keep]
        return removed

    def merge_from(self, other: "PQIndex") -> int:
        """Move every vector of ``other`` into this index. Requires the same
        codebooks and code packing (codes are copied, not re-encoded);
        returns the count moved and leaves ``other`` empty."""
        if type(other) is not type(self):
            raise InvalidParameter(
                "other",
                f"can only merge another {type(self).__name__}, "
                f"got {type(other).__name__}",
            )
        if self.pack_bits != other.pack_bits:
            raise InvalidData(
                f"cannot merge: pack_bits differs "
                f"({self.pack_bits!r} vs {other.pack_bits!r})"
            )
        a, b = self.pq.codebooks, other.pq.codebooks
        if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
            raise InvalidData("cannot merge: trained PQ codebooks differ")
        moved = other.ntotal
        if self.keep_corpus:
            if other.ntotal > 0 and other._corpus is None:
                raise InvalidData(
                    "cannot merge: self keeps a rerank corpus but other has none"
                )
            other_corpus = None if other._corpus is None else other._corpus.to(self.device)
            self._corpus = _concat_rows(self._corpus, other_corpus)
        other_codes = None if other._codes is None else other._codes.to(self.device)
        self._codes = _concat_rows(self._codes, other_codes)
        other._codes = other._corpus = None
        return moved

    def search(self, queries, k: int = 10, *,
               rerank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ids + distances for each query row."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        rerank = int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData(
                "rerank requires keep_corpus=True at index construction"
            )
        return self.pq.adc_search(
            queries, self._codes, k=min(int(k), self.ntotal), rerank=rerank,
            corpus=self._corpus if rerank else None, pack_bits=self.pack_bits,
        )

    def reconstruct(self, ids) -> torch.Tensor:
        """Approximate vectors for stored ids (decoded from codes)."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        rows = self._codes[as_tensor(ids, self.device).to(torch.int64)]
        if self.pack_bits < 8:
            rows = unpack_codes(rows.reshape(-1, rows.shape[-1]), self.pack_bits,
                                self.pq.num_subspaces).reshape(*rows.shape[:-1], -1)
        return self.pq.decode(rows)

    def save(self, path: str) -> str:
        """Write the index (codebooks, codes, kept corpus) as ``.npz``."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "PQIndex":
        """Load an index saved by either package onto ``device``."""
        kind, config, arrays = _from_npz(path)
        if kind != "pq_index":
            raise InvalidData(f"expected a pq_index checkpoint, got {kind!r}")
        return from_state(kind, config, arrays, device=device)

    def __repr__(self) -> str:
        return (
            f"PQIndex(ntotal={self.ntotal}, m={self.pq.num_subspaces}, "
            f"k={self.pq.num_centroids}, metric={self.pq.distance_metric!r}, "
            f"pack_bits={self.pack_bits})"
        )


def _rq_chunk_values(qdoty, qn2, row_sqn, metric: str):
    """``_rq_scan_jit``'s elementwise assembly of ``[Q, chunk]`` values
    (smaller is better) from ``q.y`` and the stored ``||y||^2``."""
    if metric in ("squared_euclidean", "euclidean"):
        d = torch.clamp_min(qn2[:, None] - 2.0 * qdoty + row_sqn[None, :], 0.0)
        return torch.sqrt(d) if metric == "euclidean" else d
    if metric == "cosine":
        qn = torch.sqrt(qn2)
        rn = torch.sqrt(torch.clamp_min(row_sqn, 0.0))
        denom = torch.clamp_min(qn[:, None] * rn[None, :], COSINE_NORM_EPS)
        d = torch.clamp(1.0 - qdoty / denom, 0.0, 1.0)
        degenerate = (qn[:, None] < COSINE_NORM_EPS) | (rn[None, :] < COSINE_NORM_EPS)
        return torch.where(degenerate, 1.0, d)
    return -qdoty


class RQIndex:
    """Flat asymmetric-distance index over additive (RQ) codes.

    Rows are stored as ``[n, S]`` stage codes (S bytes a vector at k <=
    256) plus one exact decoded squared norm a row, so search values are
    exact distances to the decoded corpus under ``squared_euclidean``
    (default), ``euclidean``, ``cosine`` or ``dot`` (maximum inner
    product; descending scores). ``beam`` sets the encode at :meth:`add`
    (1 = greedy); ``keep_corpus=True`` keeps the raw rows for an exact
    rerank, as :class:`PQIndex` does.
    """

    def __init__(self, quantizer: ResidualQuantizer, *, metric="squared_euclidean",
                 keep_corpus: bool = False, beam: int = 1):
        if not isinstance(quantizer, ResidualQuantizer):
            raise InvalidParameter("quantizer", "RQIndex requires a ResidualQuantizer")
        m = metric.value if isinstance(metric, Metric) else str(metric)
        if m not in _RQ_METRICS:
            raise InvalidParameter(
                "metric",
                "must be one of 'squared_euclidean', 'euclidean', 'cosine', 'dot' "
                "(manhattan does not decompose onto the asymmetric scan)",
            )
        if int(beam) < 1:
            raise InvalidParameter("beam", "must be >= 1")
        self.rq = quantizer
        self.metric = m
        self.keep_corpus = keep_corpus
        self.beam = int(beam)
        self._codes: Optional[torch.Tensor] = None  # [n, S] u8 / i32
        self._row_sqn: Optional[torch.Tensor] = None  # [n] f32
        self._corpus: Optional[torch.Tensor] = None  # [n, d] if kept

    @property
    def device(self) -> torch.device:
        return self.rq.device

    @property
    def dim(self) -> int:
        return self.rq.dim

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else int(self._codes.shape[0])

    @property
    def code_bytes_per_vector(self) -> int:
        itemsize = 1 if self.rq.num_centroids <= 256 else 4
        return self.rq.num_stages * itemsize  # +4 for the stored row norm

    def add(self, vectors) -> None:
        """Encode (K1 a stage when greedy, or beam search) and append a
        batch with its decoded squared norms. f16/bf16 batches keep a half
        kept corpus and encode as f32."""
        x = as_tensor(vectors, self.device)
        if x.dtype not in _HALF_DTYPES:
            x = x.to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        codes = self.rq.encode(x.to(torch.float32), beam=self.beam)
        y = self.rq.decode(codes)
        self._codes = _concat_rows(self._codes, codes)
        self._row_sqn = _concat_rows(self._row_sqn, (y * y).sum(-1))
        if self.keep_corpus:
            self._corpus = _concat_rows(self._corpus, x)

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; the rest renumber
        sequentially (faiss's ``remove_ids`` contract)."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        keep = _removal_keep_mask(ids, self.ntotal, self._codes.device)
        removed = self.ntotal - int(keep.sum())
        self._codes, self._row_sqn = self._codes[keep], self._row_sqn[keep]
        if self._corpus is not None:
            self._corpus = self._corpus[keep]
        return removed

    def merge_from(self, other: "RQIndex") -> int:
        """Move every vector of ``other`` into this index. Requires the
        same metric and stage codebooks (codes are copied, not
        re-encoded); returns the count moved and leaves ``other`` empty."""
        if type(other) is not type(self):
            raise InvalidParameter(
                "other", f"can only merge another {type(self).__name__}, "
                f"got {type(other).__name__}",
            )
        if self.metric != other.metric:
            raise InvalidData(
                f"cannot merge: metric differs ({self.metric!r} vs {other.metric!r})"
            )
        a, b = self.rq.codebooks, other.rq.codebooks
        if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
            raise InvalidData("cannot merge: trained RQ codebooks differ")
        moved = other.ntotal
        if self.keep_corpus:
            if other.ntotal > 0 and other._corpus is None:
                raise InvalidData("cannot merge: self keeps a rerank corpus but other has none")
            if other._corpus is not None:
                self._corpus = _concat_rows(self._corpus, other._corpus.to(self.device))
        if other._codes is not None:
            self._codes = _concat_rows(self._codes, other._codes.to(self.device))
            self._row_sqn = _concat_rows(self._row_sqn, other._row_sqn.to(self.device))
        other._codes = other._row_sqn = other._corpus = None
        return moved

    def _check_query(self, queries) -> torch.Tensor:
        q = as_tensor(queries, self.device).to(torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=q.shape[1])
        return q

    def _scan_fused(self, tables, qn2, fetch: int):
        """K5 over the stored codes plus one stable merge -> ``(ids,
        values)``, smaller-is-better, inf values with id -1."""
        codes_t = self._codes.to(torch.uint8).T.contiguous()  # [S, n]
        if self.metric == "dot":
            vals, ids = adc_scan_topk_fused(tables, codes_t, fetch, mode="dot")
        else:
            vals, ids = adc_scan_topk_fused(tables, codes_t, fetch, mode="l2", qn2=qn2,
                                            offsets=self._row_sqn)
        return _merge_candidates(vals, ids, fetch, self.metric == "euclidean")

    def _scan_chunked(self, tables, qn2, fetch: int, chunk: int):
        """The chunked scan: K8 a chunk, the metric assembled
        elementwise, a running top-``fetch`` merge."""
        nq = tables.shape[0]
        best_d = torch.full((nq, fetch), float("inf"), device=tables.device)
        best_i = torch.full((nq, fetch), -1, dtype=torch.int64, device=tables.device)
        for c0 in range(0, self.ntotal, chunk):
            qdoty = _adc_lookup(tables, self._codes[c0:c0 + chunk])
            d = _rq_chunk_values(qdoty, qn2, self._row_sqn[c0:c0 + chunk], self.metric)
            gidx = torch.arange(c0, c0 + d.shape[1], device=tables.device)
            cat_d = torch.cat([best_d, d], dim=1)
            cat_i = torch.cat([best_i, gidx[None, :].expand(nq, -1)], dim=1)
            best_d, pos = _smallest(cat_d, fetch)
            best_i = torch.gather(cat_i, 1, pos)
        return best_i.to(torch.int32), best_d

    def search(self, queries, k: int = 10, *, rerank: int = 0,
               chunk: int = 262_144) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ids + values for each query row: distances (ascending)
        for the L2 family and cosine, inner-product scores (descending)
        for ``dot``. With ``rerank=R`` and a kept corpus, a top-R shortlist
        is re-scored exactly."""
        q = self._check_query(queries)
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        rerank = int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData("rerank requires keep_corpus=True at index construction")
        n = self.ntotal
        k_eff = min(int(k), n)
        fetch = min(max(k_eff, rerank), n)
        metric = self.metric
        tables = torch.einsum("qd,skd->qsk", q, self.rq.codebooks)  # [Q, S, k]
        qn2 = (q * q).sum(-1)
        if (self.rq.num_centroids <= 256 and metric != "cosine"
                and 1 <= fetch <= 128 and fetch < n):
            ids, d = self._scan_fused(tables, qn2, fetch)
        else:
            ids, d = self._scan_chunked(tables, qn2, fetch, min(int(chunk), max(n, 1)))
        if rerank:
            cand = self._corpus[ids.clamp_min(0).to(torch.int64)].to(torch.float32)
            if metric == "dot":
                exact = torch.einsum("qd,qrd->qr", q, cand)
                neg, pos = _smallest(-exact, k_eff)
                return torch.gather(ids, 1, pos), -neg
            pair = _PAIRWISE[Metric(metric)]
            exact = torch.vmap(lambda qv, cv: pair(qv[None, :], cv)[0])(q, cand)
            vals, pos = _smallest(exact, k_eff)
            return torch.gather(ids, 1, pos), vals
        if metric == "dot":
            return ids[:, :k_eff], -d[:, :k_eff]
        return ids[:, :k_eff], d[:, :k_eff]

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded (approximate) vectors for stored ids."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        return self.rq.decode(self._codes[as_tensor(ids, self.device).to(torch.int64)])

    def save(self, path: str) -> str:
        """Write the index (codebooks, codes, norms, kept corpus) as an
        ``rq_index`` ``.npz``."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "RQIndex":
        """Load an ``rq_index`` saved by either package onto ``device``."""
        kind, config, arrays = _from_npz(path)
        if kind != "rq_index":
            raise InvalidData(f"expected an rq_index checkpoint, got {kind!r}")
        return from_state(kind, config, arrays, device=device)

    def __repr__(self) -> str:
        return (
            f"RQIndex(ntotal={self.ntotal}, stages={self.rq.num_stages}, "
            f"k={self.rq.num_centroids}, metric={self.metric!r}, beam={self.beam})"
        )
