"""Search indexes — the flat serving layer of ``vq_tpu.search``.

* :class:`FlatIndex` — exact brute-force scan over raw rows (f32, bf16 or
  f16 storage, upcast to f32 a chunk at a time), all five metrics,
  ``range_search``. The recall baseline for everything below.
* :class:`PQIndex` — PQ codes: ``add`` encodes a batch (K4 on the card),
  ``search`` is the flat ADC top-k (K5 on the card) with an optional exact
  rerank from the kept raw corpus; ``range_search`` sums the ADC tables a
  chunk at a time through K8.
* :class:`BinaryIndex` — sign bits packed 32 to a word, scanned by their
  Hamming count (BQ), with an optional exact squared-L2 rerank.
* :class:`SQIndex` — per-dimension scalar-quantized rows (SQ8, or 4, 2 or
  1 bits a code packed by the level count) scanned asymmetrically:
  ``q.y = q.lo + (q*step).c`` is one f32 product a chunk plus the stored
  ``||decode(row)||^2``.
* :class:`RQIndex` — ``[n, S]`` stage codes and each row's exact decoded
  squared norm (additive codes have cross-stage norm terms that
  per-stage tables cannot express, as in faiss's
  ``IndexResidualQuantizer``). Its search builds per-stage dot tables
  ``T[q, s, j] = q.C_s[j]`` and takes one of two routes, which return the
  same ids and values: K5 in mode ``"l2"`` or ``"dot"`` plus one stable
  merge, when k <= 256, the metric is squared-L2, L2 or dot,
  ``1 <= fetch <= 128`` and ``fetch < n`` (the JAX package also gates on
  the TPU backend, its VMEM budget and ``n > 32768``; those gates are not
  ported); otherwise the chunked scan of ``_rq_scan_jit`` (K8 a chunk).

The Flat, SQ and RQ chunked scans and the PQ range scan assemble each
chunk's values elementwise and merge them into a running top-``fetch``
(:func:`vq_tpu_torch.models.pq._topk_scan`), counting ``range_search``'s
radius hits in the same pass; the decomposable metrics' products are
``torch.matmul`` in full f32 (TF32 is off). Every top-k keeps
``jax.lax.top_k``'s order — ascending, the lowest position first on ties
— except where the reference's own order is at fault: it negates the
values and ranks the floats' total order, so a NaN with its sign bit set
ranks first and -0.0 before +0.0 (``ROADMAP.md``, R8); the port ranks
every NaN last and ties +-0.0 by position.

Each index lives on one device: the quantizer's, or for Flat and Binary
the one given at construction (the card unless the caller asks for the
CPU). ``_search_core`` gives a search as ``(fn, arrays)`` with ``fn(q,
*arrays)`` equal to :meth:`search`, and ``_reconstruct_core`` a
reconstruct as ``(fn, arrays)`` with ``fn(ids, *arrays)``: the forms the
JAX package's batch pipeline and refine index build on.
"""

from __future__ import annotations

from operator import attrgetter
from typing import Optional, Tuple

import torch

from vq_tpu_torch.convert import from_state
from vq_tpu_torch.errors import (
    DimensionMismatch,
    EmptyInput,
    InvalidData,
    InvalidParameter,
)
from vq_tpu_torch.models.base import _HALF_DTYPES, as_tensor, resolve_device
from vq_tpu_torch.models.bq import BinaryQuantizer, hamming_distance
from vq_tpu_torch.models.pq import (
    ProductQuantizer,
    _adc_lookup,
    _merge_candidates,
    _smallest,
    _topk_scan,
)
from vq_tpu_torch.models.rq import ResidualQuantizer
from vq_tpu_torch.models.sq import PerDimScalarQuantizer
from vq_tpu_torch.ops.cuda_kernels import adc_scan_topk_fused
from vq_tpu_torch.ops.distance import COSINE_NORM_EPS, _PAIRWISE, Metric
from vq_tpu_torch.ops.packing import bits_for, pack_codes, unpack_codes
from vq_tpu_torch.utils.serialize import _from_npz, save

__all__ = ["FlatIndex", "PQIndex", "BinaryIndex", "SQIndex", "RQIndex"]

_FLAT_METRICS = ("squared_euclidean", "euclidean", "cosine", "dot", "manhattan")
_SQ_METRICS = ("squared_euclidean", "euclidean", "cosine", "dot")
_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_CHUNK = 262_144


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------


def _metric_name(metric, allowed, message: str) -> str:
    m = metric.value if isinstance(metric, Metric) else str(metric)
    if m not in allowed:
        raise InvalidParameter("metric", message)
    return m


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


def _compact_rows(mask: torch.Tensor, *arrays):
    """Drop masked-out rows from each (possibly-None) array."""
    return tuple(None if a is None else a[mask] for a in arrays)


def _concat_rows(a, b, device=None):
    """Row-concatenate two optional tensors (either may be None), ``b``
    moved to ``device`` first when one is given."""
    if b is None:
        return a
    if device is not None:
        b = b.to(device)
    return b if a is None else torch.cat([a, b], dim=0)


def _merge_check(self, other, *, attrs=(), arrays=()):
    """Validate that ``other`` is mergeable into ``self`` (faiss
    ``merge_from`` contract: same index type, same trained state).
    ``attrs`` are attribute names that must compare equal; ``arrays`` are
    ``(label, dotted attribute)`` pairs naming trained tensors that must
    match elementwise."""
    if type(other) is not type(self):
        raise InvalidParameter(
            "other",
            f"can only merge another {type(self).__name__}, "
            f"got {type(other).__name__}",
        )
    for name in attrs:
        if getattr(self, name) != getattr(other, name):
            raise InvalidData(
                f"cannot merge: {name} differs "
                f"({getattr(self, name)!r} vs {getattr(other, name)!r})"
            )
    for label, path in arrays:
        a, b = attrgetter(path)(self), attrgetter(path)(other)
        same = (a is None and b is None) or (
            a is not None and b is not None and a.shape == b.shape
            and torch.equal(a, b.to(a.device))
        )
        if not same:
            raise InvalidData(f"cannot merge: trained {label} differ")


def _merge_corpus(self, other) -> None:
    """Carry the kept corpus across a merge. If ``self`` reranks from a
    kept corpus, ``other`` must have one too (otherwise rerank on the
    merged index would silently cover only part of the data)."""
    if not self.keep_corpus:
        return
    if other.ntotal > 0 and other._corpus is None:
        raise InvalidData("cannot merge: self keeps a rerank corpus but other has none")
    self._corpus = _concat_rows(self._corpus, other._corpus, self.device)


def _search_and_reconstruct(self, queries, k: int = 10, **kw):
    """Shared ``search_and_reconstruct`` body (faiss analog): search, then
    decode every returned id. Padded ``-1`` ids reconstruct as zero rows.
    Returns ``(ids [Q, k], values [Q, k], vectors [Q, k, d])``."""
    ids, vals = self.search(queries, k, **kw)
    flat = ids.reshape(-1)
    rec = self.reconstruct(flat.clamp_min(0))
    rec = torch.where((flat >= 0)[:, None], rec, 0.0)
    return ids, vals, rec.reshape(*ids.shape, rec.shape[-1])


def _check_query(queries, dim: int, device) -> torch.Tensor:
    q = as_tensor(queries, device).to(torch.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[1] != dim:
        raise DimensionMismatch(expected=dim, found=q.shape[1])
    return q


def _check_range(ntotal: int, max_results: int) -> int:
    if ntotal == 0:
        raise EmptyInput("index is empty — add() vectors first")
    if int(max_results) < 1:
        raise InvalidParameter("max_results", "must be >= 1")
    return min(int(max_results), ntotal)


def _range_result(ids, d, counts, rad: float, dot: bool):
    """``range_search``'s output from a radius scan: misses become -1 /
    +inf (-inf scores for ``dot``, whose values come back negated)."""
    hit = d <= rad
    ids = torch.where(hit, ids, -1)
    d = torch.where(hit, d, float("inf"))
    return (ids, -d, counts) if dot else (ids, d, counts)


def _chunk_values(qdoty, qn2, row_sqn, metric: str):
    """Elementwise assembly of ``[Q, chunk]`` values (smaller is better)
    from ``q.y`` and the stored ``||y||^2``, as ``_flat_scan_jit``,
    ``_sq_scan_jit`` and ``_rq_scan_jit`` assemble them; ``dot`` is
    the negated score."""
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


def _rerank(q, ids, corpus, metric: str, k: int):
    """Re-score the shortlist ``ids [Q, R]`` exactly from the kept corpus
    (gathered first, upcast after) -> the best ``k`` as ``(ids, values)``:
    descending scores for ``dot``, ascending distances otherwise."""
    cand = corpus[ids.clamp_min(0).to(torch.int64)].to(torch.float32)
    if metric == "dot":
        exact = torch.einsum("qd,qrd->qr", q, cand)
        neg, pos = _smallest(-exact, k)
        return torch.gather(ids, 1, pos), -neg
    pair = _PAIRWISE[Metric(metric)]
    exact = torch.vmap(lambda qv, cv: pair(qv[None, :], cv)[0])(q, cand)
    vals, pos = _smallest(exact, k)
    return torch.gather(ids, 1, pos), vals


def _top_values(ids, d, k: int, metric: str):
    """The first ``k`` of a scan's ``(ids, values)``; ``dot``'s negated
    values turned back into scores."""
    ids, d = ids[:, :k], d[:, :k]
    return (ids, -d) if metric == "dot" else (ids, d)


# ---------------------------------------------------------------------------
# FlatIndex.
# ---------------------------------------------------------------------------


def _flat_scan(q, rows, row_sqn, metric: str, fetch: int, chunk: int, radius=None):
    """Blockwise exact scan over raw rows (``_flat_scan_jit``): one f32
    ``[Q, d] x [d, chunk]`` product a block plus the stored row norms, or
    Manhattan's ``[Q, chunk, d]`` broadcast-reduce."""
    qn2 = (q * q).sum(-1)

    def values(c0, c1):
        c = rows[c0:c1].to(torch.float32)
        if metric == "manhattan":
            return (q[:, None, :] - c[None, :, :]).abs().sum(-1)
        return _chunk_values(q @ c.T, qn2, row_sqn[c0:c1], metric)

    return _topk_scan(values, rows.shape[0], q.shape[0], fetch, chunk, q.device, radius)


class FlatIndex:
    """Exact brute-force index over raw corpus rows (faiss ``IndexFlat``
    analog — the baseline every quantized index is measured against).

    Rows are stored at ``storage`` width (``"float32"`` exact,
    ``"bfloat16"`` / ``"float16"`` for half the bytes); distances are
    exact distances to the stored rows. Metrics: ``squared_euclidean``
    (default), ``euclidean``, ``cosine``, ``manhattan`` (a broadcast-reduce
    over ``[Q, chunk, d]``, so a smaller default chunk) and ``dot``
    (maximum inner product; descending scores). ``device``: where the rows
    live (the card unless the caller asks for the CPU).

    >>> import numpy as np
    >>> idx = FlatIndex.from_data(
    ...     np.array([[0., 0.], [1., 1.], [2., 2.]], np.float32), device="cpu"
    ... )
    >>> ids, dist = idx.search(np.array([[0.9, 0.9]], np.float32), k=2)
    >>> ids.tolist()
    [[1, 0]]
    """

    def __init__(self, dim: int, *, metric: str = "squared_euclidean",
                 storage: str = "float32", device=None):
        if int(dim) < 1:
            raise InvalidParameter("dim", "must be >= 1")
        self.metric = _metric_name(metric, _FLAT_METRICS,
                                   f"must be one of {', '.join(_FLAT_METRICS)}")
        if storage not in _STORAGE:
            raise InvalidParameter("storage", "must be 'float32', 'bfloat16', or 'float16'")
        self.dim = int(dim)
        self.storage = storage
        self._device = resolve_device(device)
        self._rows: Optional[torch.Tensor] = None  # [n, d] storage dtype
        self._row_sqn: Optional[torch.Tensor] = None  # [n] f32

    @classmethod
    def from_data(cls, data, *, metric: str = "squared_euclidean",
                  storage: str = "float32", device=None) -> "FlatIndex":
        """Build an index holding ``data`` (on its device, or ``device``)."""
        x = as_tensor(data, device)
        idx = cls(x.shape[-1], metric=metric, storage=storage, device=x.device)
        idx.add(x)
        return idx

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def ntotal(self) -> int:
        return 0 if self._rows is None else int(self._rows.shape[0])

    @property
    def code_bytes_per_vector(self) -> int:
        return self.dim * (4 if self.storage == "float32" else 2)

    def add(self, vectors) -> None:
        """Append a batch of raw vectors (stored at ``storage`` width)."""
        x = as_tensor(vectors, self._device)
        if x.dtype not in _HALF_DTYPES:
            x = x.to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        rows = x.to(_STORAGE[self.storage])
        r = rows.to(torch.float32)
        self._rows = _concat_rows(self._rows, rows)
        self._row_sqn = _concat_rows(self._row_sqn, (r * r).sum(-1))

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; remaining vectors renumber
        sequentially (faiss ``remove_ids`` contract)."""
        if self._rows is None:
            raise EmptyInput("index is empty")
        keep = _removal_keep_mask(ids, self.ntotal, self._device)
        removed = self.ntotal - int(keep.sum())
        self._rows, self._row_sqn = _compact_rows(keep, self._rows, self._row_sqn)
        return removed

    def merge_from(self, other: "FlatIndex") -> int:
        """Move every vector of ``other`` into this index (same type and
        build parameters; the moved vectors get ids from ``self.ntotal``
        on, and ``other`` is left empty). Returns the number moved."""
        _merge_check(self, other, attrs=("dim", "metric", "storage"))
        moved = other.ntotal
        self._rows = _concat_rows(self._rows, other._rows, self._device)
        self._row_sqn = _concat_rows(self._row_sqn, other._row_sqn, self._device)
        other._rows = other._row_sqn = None
        return moved

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the stored vectors of every hit — ``(ids, values,
        vectors [Q, k, d])``; padded ``-1`` ids yield zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    def _default_chunk(self, chunk: Optional[int]) -> int:
        if chunk is not None:
            return int(chunk)
        # Manhattan materializes a [Q, chunk, d] broadcast per block.
        return 8_192 if self.metric == "manhattan" else _CHUNK

    def search(self, queries, k: int = 10, *,
               chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k ids + values for each query row: distances
        (ascending), or inner-product scores (descending) for ``dot``."""
        fn, arrays = self._search_core(int(k), chunk=chunk)
        return fn(_check_query(queries, self.dim, self._device), *arrays)

    def _search_core(self, k: int, *, chunk: Optional[int] = None):
        """The search as ``(fn, arrays)``: ``fn(q, rows, row_sqn)`` with f32
        queries ``q [Q, d]`` is :meth:`search`."""
        if self._rows is None:
            raise EmptyInput("index is empty — add() vectors first")
        n = self.ntotal
        k_eff = min(int(k), n)
        chunk = min(self._default_chunk(chunk), max(n, 1))
        metric = self.metric

        def fn(q, rows, row_sqn):
            ids, d, _ = _flat_scan(q, rows, row_sqn, metric, k_eff, chunk)
            return _top_values(ids, d, k_eff, metric)

        return fn, (self._rows, self._row_sqn)

    def range_search(self, queries, radius: float, *, max_results: int = 1024,
                     chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """All stored rows within ``radius`` of each query (faiss
        ``range_search`` analog, fixed-shape).

        For distance metrics a hit is ``value <= radius``; for ``dot`` a
        hit is ``score >= radius``. Returns ``(ids, values, counts)``:
        ``ids`` / ``values`` are ``[Q, max_results]`` holding the best hits
        padded with ``-1`` / ``inf`` (``-inf`` scores for dot), and
        ``counts[q]`` is the true number of hits — if it exceeds
        ``max_results``, re-run with a larger cap to retrieve them all.
        """
        fetch = _check_range(self.ntotal, max_results)
        q = _check_query(queries, self.dim, self._device)
        dot = self.metric == "dot"
        rad = -float(radius) if dot else float(radius)
        chunk = min(self._default_chunk(chunk), max(self.ntotal, 1))
        ids, d, counts = _flat_scan(q, self._rows, self._row_sqn, self.metric, fetch, chunk, rad)
        return _range_result(ids, d, counts, rad, dot)

    def reconstruct(self, ids) -> torch.Tensor:
        """Stored rows for the given ids (exact up to storage width), f32."""
        if self._rows is None:
            raise EmptyInput("index is empty")
        return self._rows[as_tensor(ids, self._device).to(torch.int64)].to(torch.float32)

    def save(self, path: str) -> str:
        """Write the index as a ``flat_index`` ``.npz`` (bf16 rows as f32,
        which is lossless)."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "FlatIndex":
        """Load a ``flat_index`` saved by either package onto ``device``."""
        return _load(path, "flat_index", device)

    def __repr__(self) -> str:
        return (
            f"FlatIndex(ntotal={self.ntotal}, dim={self.dim}, "
            f"metric={self.metric!r}, storage={self.storage!r})"
        )


def _load(path: str, kind: str, device):
    got, config, arrays = _from_npz(path)
    if got != kind:
        raise InvalidData(f"expected a {kind} checkpoint, got {got!r}")
    return from_state(got, config, arrays, device=device)


# ---------------------------------------------------------------------------
# PQIndex.
# ---------------------------------------------------------------------------


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
        self._codes, self._corpus = _compact_rows(keep, self._codes, self._corpus)
        return removed

    def merge_from(self, other: "PQIndex") -> int:
        """Move every vector of ``other`` into this index. Requires the same
        codebooks and code packing (codes are copied, not re-encoded);
        returns the count moved and leaves ``other`` empty."""
        _merge_check(self, other, attrs=("pack_bits",),
                     arrays=(("PQ codebooks", "pq.codebooks"),))
        moved = other.ntotal
        _merge_corpus(self, other)
        self._codes = _concat_rows(self._codes, other._codes, self.device)
        other._codes = other._corpus = None
        return moved

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the decoded codes of every hit — ``(ids, values,
        vectors [Q, k, d])``; padded ``-1`` ids yield zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    def search(self, queries, k: int = 10, *,
               rerank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ids + distances for each query row."""
        fn, arrays = self._search_core(int(k), rerank=rerank)
        return fn(queries, *arrays)

    def _search_core(self, k: int, *, rerank: int = 0):
        """The search as ``(fn, arrays)``: ``fn(q, codes[, corpus])`` is
        :meth:`search` (the codebooks ride inside the quantizer)."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        rerank = int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData(
                "rerank requires keep_corpus=True at index construction"
            )
        k_eff = min(int(k), self.ntotal)
        pq, pack_bits = self.pq, self.pack_bits
        arrays = (self._codes,) + ((self._corpus,) if rerank else ())

        def fn(q, codes, *rest):
            return pq.adc_search(q, codes, k=k_eff, rerank=rerank,
                                 corpus=rest[0] if rerank else None, pack_bits=pack_bits)

        return fn, arrays

    def range_search(self, queries, radius: float, *, max_results: int = 1024,
                     chunk: int = _CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """All rows whose ADC (asymmetric) distance is within ``radius`` of
        each query — the contract of :meth:`FlatIndex.range_search` (the
        best ``max_results`` hits padded with ``-1`` / ``inf``, plus the
        true hit counts). The scan sums the tables a chunk at a time
        through K8 on the card; packed codes unpack a chunk at a time."""
        fetch = _check_range(self.ntotal, max_results)
        q = _check_query(queries, self.pq.dim, self.device)
        chunk = min(int(chunk), max(self.ntotal, 1))
        ids, d, counts = self.pq._adc_search_chunked(
            q, self._codes, fetch, chunk, pack_bits=self.pack_bits, radius=float(radius))
        return _range_result(ids, d, counts, float(radius), False)

    def reconstruct(self, ids) -> torch.Tensor:
        """Approximate vectors for stored ids (decoded from codes)."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        return self._reconstruct_core()[0](ids, self._codes)

    def _reconstruct_core(self):
        """:meth:`reconstruct` as ``(fn, arrays)``: ``fn(ids [N], codes)
        -> [N, d]`` f32."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        pq, pack_bits = self.pq, self.pack_bits

        def fn(ids, codes):
            rows = codes[as_tensor(ids, codes.device).to(torch.int64)]
            if pack_bits < 8:
                rows = unpack_codes(rows.reshape(-1, rows.shape[-1]), pack_bits,
                                    pq.num_subspaces).reshape(*rows.shape[:-1], -1)
            return pq.decode(rows)

        return fn, (self._codes,)

    def save(self, path: str) -> str:
        """Write the index (codebooks, codes, kept corpus) as ``.npz``."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "PQIndex":
        """Load an index saved by either package onto ``device``."""
        return _load(path, "pq_index", device)

    def __repr__(self) -> str:
        return (
            f"PQIndex(ntotal={self.ntotal}, m={self.pq.num_subspaces}, "
            f"k={self.pq.num_centroids}, metric={self.pq.distance_metric!r}, "
            f"pack_bits={self.pack_bits})"
        )


# ---------------------------------------------------------------------------
# BinaryIndex.
# ---------------------------------------------------------------------------


class BinaryIndex:
    """Flat Hamming index over packed sign bits (32x compression): rows
    ``>= threshold`` set their bit, and a search ranks by the Hamming
    count (values are f32 counts). ``keep_corpus=True`` keeps the raw rows
    for ``search(..., rerank=R)``: the top-R by Hamming count re-ranked by
    exact squared L2."""

    def __init__(self, dim: int, threshold: float = 0.0, *, keep_corpus: bool = False,
                 device=None):
        self.dim = int(dim)
        self.bq = BinaryQuantizer(threshold)
        self.keep_corpus = keep_corpus
        self._device = resolve_device(device)
        self._packed: Optional[torch.Tensor] = None  # [n, words] uint32
        self._corpus: Optional[torch.Tensor] = None  # [n, d] f32 if kept

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def ntotal(self) -> int:
        return 0 if self._packed is None else int(self._packed.shape[0])

    def add(self, vectors) -> None:
        """Binarize, pack and append a batch of raw vectors."""
        x = _check_query(vectors, self.dim, self._device)
        self._packed = _concat_rows(self._packed, self.bq.quantize_packed(x))
        if self.keep_corpus:
            self._corpus = _concat_rows(self._corpus, x)

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; remaining vectors renumber
        sequentially (faiss ``remove_ids`` contract)."""
        if self._packed is None:
            raise EmptyInput("index is empty")
        keep = _removal_keep_mask(ids, self.ntotal, self._device)
        removed = self.ntotal - int(keep.sum())
        self._packed, self._corpus = _compact_rows(keep, self._packed, self._corpus)
        return removed

    def merge_from(self, other: "BinaryIndex") -> int:
        """Move every vector of ``other`` into this index. Requires the
        same dimension and threshold (packed codes are copied). Returns
        the count moved; ``other`` is left empty."""
        _merge_check(self, other, attrs=("dim",))
        if self.bq.threshold != other.bq.threshold:
            raise InvalidData("cannot merge: thresholds differ")
        moved = other.ntotal
        _merge_corpus(self, other)
        self._packed = _concat_rows(self._packed, other._packed, self._device)
        other._packed = other._corpus = None
        return moved

    def search(self, queries, k: int = 10, *,
               rerank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ids + Hamming distances (or exact squared L2 when
        reranked)."""
        fn, arrays = self._search_core(int(k), rerank=rerank)
        return fn(_check_query(queries, self.dim, self._device), *arrays)

    def _search_core(self, k: int, *, rerank: int = 0):
        """The search as ``(fn, arrays)``: ``fn(q, packed[, corpus])`` with
        f32 queries ``q [Q, d]`` is :meth:`search`."""
        if self._packed is None:
            raise EmptyInput("index is empty — add() vectors first")
        rerank = int(rerank)
        if rerank and self._corpus is None:
            # Silently falling back to unreranked Hamming results would
            # hide the misuse.
            raise InvalidData(
                "rerank requires keep_corpus=True at index construction"
            )
        k_eff = min(int(k), self.ntotal)
        r = min(rerank, self.ntotal)
        bq = self.bq
        arrays = (self._packed,) + ((self._corpus,) if rerank else ())

        def fn(q, packed, *rest):
            ham = hamming_distance(bq.quantize_packed(q), packed)  # [Q, n] int32
            if rerank:
                short = _smallest(ham, r)[1]
                cand = rest[0][short]  # [Q, R, d]
                exact = ((cand - q[:, None, :]) ** 2).sum(-1)
                vals, pos = _smallest(exact, min(k_eff, r))
                return torch.gather(short, 1, pos).to(torch.int32), vals
            vals, ids = _smallest(ham.to(torch.float32), k_eff)
            return ids.to(torch.int32), vals

        return fn, arrays

    def save(self, path: str) -> str:
        """Write the index as a ``binary_index`` ``.npz``."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "BinaryIndex":
        """Load a ``binary_index`` saved by either package onto ``device``."""
        return _load(path, "binary_index", device)

    def __repr__(self) -> str:
        return f"BinaryIndex(ntotal={self.ntotal}, dim={self.dim})"


# ---------------------------------------------------------------------------
# SQIndex.
# ---------------------------------------------------------------------------


def _sq_scan(q, lo, step, codes, row_sqn, metric: str, fetch: int, chunk: int,
             pack_bits: int, radius=None):
    """Blockwise asymmetric scan over scalar-quantized rows
    (``_sq_scan_jit``): every decoded row is ``lo + c*step``, so
    ``q.y = q.lo + (q*step).c``, one f32 product a block over the codes
    (unpacked a block at a time when sub-byte)."""
    dim = q.shape[1]
    qs = q * step[None, :]
    qlo = q @ lo
    qn2 = (q * q).sum(-1)

    def values(c0, c1):
        block = codes[c0:c1]
        if pack_bits < 8:
            block = unpack_codes(block, pack_bits, dim)
        qdoty = qlo[:, None] + qs @ block.to(torch.float32).T
        return _chunk_values(qdoty, qn2, row_sqn[c0:c1], metric)

    return _topk_scan(values, codes.shape[0], q.shape[0], fetch, chunk, q.device, radius)


class SQIndex:
    """Flat asymmetric-distance index over scalar-quantized rows (the
    faiss ``IndexScalarQuantizer`` analog). Rows are stored as u8 codes
    (packed 2, 4 or 8 to a byte at 16, 4 or 2 levels) plus one f32 squared
    norm of the decoded row; queries stay f32, so search values are exact
    distances to the decoded corpus. Metrics: ``squared_euclidean``
    (default), ``euclidean``, ``cosine`` and ``dot`` (descending scores);
    Manhattan does not decompose and is rejected. ``keep_corpus=True``
    keeps raw rows for an exact rerank, as :class:`PQIndex` does.
    """

    def __init__(self, quantizer: PerDimScalarQuantizer, *, metric: str = "squared_euclidean",
                 keep_corpus: bool = False):
        if not isinstance(quantizer, PerDimScalarQuantizer):
            raise InvalidParameter(
                "quantizer",
                "SQIndex requires a PerDimScalarQuantizer (use "
                "PerDimScalarQuantizer.from_data or SQIndex.from_data)",
            )
        self.metric = _metric_name(
            metric, _SQ_METRICS,
            "must be one of 'squared_euclidean', 'euclidean', 'cosine', 'dot' "
            "(manhattan does not decompose onto the asymmetric scan)")
        self.sq = quantizer
        self.keep_corpus = keep_corpus
        lv = quantizer.levels
        self.pack_bits = 1 if lv <= 2 else 2 if lv <= 4 else 4 if lv <= 16 else 8
        self._codes: Optional[torch.Tensor] = None  # [n, B] u8 (packed)
        self._row_sqn: Optional[torch.Tensor] = None  # [n] f32
        self._corpus: Optional[torch.Tensor] = None  # [n, d] if kept

    @classmethod
    def from_data(cls, data, levels: int = 256, *, metric: str = "squared_euclidean",
                  keep_corpus: bool = False, device=None) -> "SQIndex":
        """Fit per-dimension ranges from ``data``, build, and add it."""
        x = as_tensor(data, device)
        idx = cls(PerDimScalarQuantizer.from_data(x, levels), metric=metric,
                  keep_corpus=keep_corpus)
        idx.add(x)
        return idx

    @property
    def device(self) -> torch.device:
        return self.sq.device

    @property
    def dim(self) -> int:
        return self.sq.dim

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else int(self._codes.shape[0])

    @property
    def code_bytes_per_vector(self) -> int:
        return -(-self.dim * self.pack_bits // 8)  # (+4 for the stored row norm)

    def add(self, vectors) -> None:
        """Quantize and append a batch of raw vectors."""
        x = as_tensor(vectors, self.device)
        if x.dtype not in _HALF_DTYPES:
            x = x.to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        codes = self.sq.quantize(x.to(torch.float32))
        y = self.sq.dequantize(codes)
        if self.pack_bits < 8:
            codes = pack_codes(codes, self.pack_bits)
        self._codes = _concat_rows(self._codes, codes)
        self._row_sqn = _concat_rows(self._row_sqn, (y * y).sum(-1))
        if self.keep_corpus:
            self._corpus = _concat_rows(self._corpus, x)

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; remaining vectors renumber
        sequentially (faiss ``remove_ids`` contract)."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        keep = _removal_keep_mask(ids, self.ntotal, self.device)
        removed = self.ntotal - int(keep.sum())
        self._codes, self._row_sqn, self._corpus = _compact_rows(
            keep, self._codes, self._row_sqn, self._corpus)
        return removed

    def merge_from(self, other: "SQIndex") -> int:
        """Move every vector of ``other`` into this index. Requires the
        same metric and fitted ranges (codes are copied, not
        re-quantized). Returns the count moved; ``other`` is left empty."""
        _merge_check(self, other, attrs=("metric",),
                     arrays=(("SQ lo", "sq.mins"), ("SQ hi", "sq.maxs")))
        if self.sq.levels != other.sq.levels:
            raise InvalidData("cannot merge: SQ levels differ")
        moved = other.ntotal
        _merge_corpus(self, other)
        self._codes = _concat_rows(self._codes, other._codes, self.device)
        self._row_sqn = _concat_rows(self._row_sqn, other._row_sqn, self.device)
        other._codes = other._row_sqn = other._corpus = None
        return moved

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the decoded rows of every hit — ``(ids, values,
        vectors [Q, k, d])``; padded ``-1`` ids yield zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    def range_search(self, queries, radius: float, *, max_results: int = 1024,
                     chunk: int = _CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """All rows whose asymmetric (decoded-corpus) value is within
        ``radius`` of each query — the contract of
        :meth:`FlatIndex.range_search`."""
        fetch = _check_range(self.ntotal, max_results)
        q = _check_query(queries, self.dim, self.device)
        dot = self.metric == "dot"
        rad = -float(radius) if dot else float(radius)
        ids, d, counts = _sq_scan(q, self.sq.mins, self.sq.steps, self._codes, self._row_sqn,
                                  self.metric, fetch, min(int(chunk), max(self.ntotal, 1)),
                                  self.pack_bits, rad)
        return _range_result(ids, d, counts, rad, dot)

    def search(self, queries, k: int = 10, *, rerank: int = 0,
               chunk: int = _CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ids + values for each query row: distances (ascending)
        for the L2 family and cosine, scores (descending) for ``dot``. With
        ``rerank=R`` and a kept corpus, a top-R shortlist is re-scored
        exactly."""
        q = _check_query(queries, self.dim, self.device)
        fn, arrays = self._search_core(int(k), rerank=rerank, chunk=chunk)
        return fn(q, *arrays)

    def _search_core(self, k: int, *, rerank: int = 0, chunk: int = _CHUNK):
        """The search as ``(fn, arrays)``: ``fn(q, codes, row_sqn, mins,
        steps[, corpus])`` with f32 queries ``q [Q, d]`` is :meth:`search`."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        rerank = int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData("rerank requires keep_corpus=True at index construction")
        n = self.ntotal
        k_eff = min(int(k), n)
        fetch = min(max(k_eff, rerank), n)
        chunk = min(int(chunk), max(n, 1))
        metric, pack_bits = self.metric, self.pack_bits
        arrays = (self._codes, self._row_sqn, self.sq.mins, self.sq.steps) + (
            (self._corpus,) if rerank else ())

        def fn(q, codes, row_sqn, mins, steps, *rest):
            ids, d, _ = _sq_scan(q, mins, steps, codes, row_sqn, metric, fetch, chunk, pack_bits)
            if rerank:
                return _rerank(q, ids, rest[0], metric, k_eff)
            return _top_values(ids, d, k_eff, metric)

        return fn, arrays

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded (approximate) vectors for stored ids."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        return self._reconstruct_core()[0](ids, self._codes)

    def _reconstruct_core(self):
        """:meth:`reconstruct` as ``(fn, arrays)``: ``fn(ids [N], codes)
        -> [N, d]`` f32."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        sq, pack_bits, dim = self.sq, self.pack_bits, self.dim

        def fn(ids, codes):
            rows = codes[as_tensor(ids, codes.device).to(torch.int64)]
            if pack_bits < 8:
                rows = unpack_codes(rows.reshape(-1, rows.shape[-1]), pack_bits,
                                    dim).reshape(*rows.shape[:-1], dim)
            return sq.dequantize(rows)

        return fn, (self._codes,)

    def save(self, path: str) -> str:
        """Write the index as an ``sq_index`` ``.npz``."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "SQIndex":
        """Load an ``sq_index`` saved by either package onto ``device``."""
        return _load(path, "sq_index", device)

    def __repr__(self) -> str:
        return (
            f"SQIndex(ntotal={self.ntotal}, dim={self.dim}, "
            f"levels={self.sq.levels}, metric={self.metric!r})"
        )


# ---------------------------------------------------------------------------
# RQIndex.
# ---------------------------------------------------------------------------


def _rq_scan_fused(tables, qn2, codes, row_sqn, fetch: int, metric: str):
    """K5 over the stored codes plus one stable merge -> ``(ids,
    values)``, smaller-is-better, inf values with id -1."""
    codes_t = codes.to(torch.uint8).T.contiguous()  # [S, n]
    if metric == "dot":
        vals, ids = adc_scan_topk_fused(tables, codes_t, fetch, mode="dot")
    else:
        vals, ids = adc_scan_topk_fused(tables, codes_t, fetch, mode="l2", qn2=qn2,
                                        offsets=row_sqn)
    return _merge_candidates(vals, ids, fetch, metric == "euclidean")


def _rq_scan_chunked(tables, qn2, codes, row_sqn, metric: str, fetch: int, chunk: int,
                     radius=None):
    """The chunked scan (``_rq_scan_jit``): K8 a chunk, the metric
    assembled elementwise, a running top-``fetch`` merge, and the radius
    hits -> ``(ids, values, hits)``."""

    def values(c0, c1):
        return _chunk_values(_adc_lookup(tables, codes[c0:c1]), qn2, row_sqn[c0:c1], metric)

    return _topk_scan(values, codes.shape[0], tables.shape[0], fetch, chunk, tables.device,
                      radius)


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
        m = _metric_name(
            metric, _SQ_METRICS,
            "must be one of 'squared_euclidean', 'euclidean', 'cosine', 'dot' "
            "(manhattan does not decompose onto the asymmetric scan)")
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
        self._codes, self._row_sqn, self._corpus = _compact_rows(
            keep, self._codes, self._row_sqn, self._corpus)
        return removed

    def merge_from(self, other: "RQIndex") -> int:
        """Move every vector of ``other`` into this index. Requires the
        same metric and stage codebooks (codes are copied, not
        re-encoded); returns the count moved and leaves ``other`` empty."""
        _merge_check(self, other, attrs=("metric",),
                     arrays=(("RQ codebooks", "rq.codebooks"),))
        moved = other.ntotal
        _merge_corpus(self, other)
        self._codes = _concat_rows(self._codes, other._codes, self.device)
        self._row_sqn = _concat_rows(self._row_sqn, other._row_sqn, self.device)
        other._codes = other._row_sqn = other._corpus = None
        return moved

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the decoded codes of every hit — ``(ids, values,
        vectors [Q, k, d])``; padded ``-1`` ids yield zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    def range_search(self, queries, radius: float, *, max_results: int = 1024,
                     chunk: int = _CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """All rows whose asymmetric (decoded-corpus) value is within
        ``radius`` of each query — the contract of
        :meth:`FlatIndex.range_search`; the chunked scan (K8 a chunk)."""
        fetch = _check_range(self.ntotal, max_results)
        q = _check_query(queries, self.dim, self.device)
        dot = self.metric == "dot"
        rad = -float(radius) if dot else float(radius)
        tables = torch.einsum("qd,skd->qsk", q, self.rq.codebooks)
        ids, d, counts = _rq_scan_chunked(
            tables, (q * q).sum(-1), self._codes, self._row_sqn, self.metric, fetch,
            min(int(chunk), max(self.ntotal, 1)), rad)
        return _range_result(ids, d, counts, rad, dot)

    def search(self, queries, k: int = 10, *, rerank: int = 0,
               chunk: int = _CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ids + values for each query row: distances (ascending)
        for the L2 family and cosine, inner-product scores (descending)
        for ``dot``. With ``rerank=R`` and a kept corpus, a top-R shortlist
        is re-scored exactly."""
        q = _check_query(queries, self.dim, self.device)
        fn, arrays = self._search_core(int(k), rerank=rerank, chunk=chunk)
        return fn(q, *arrays)

    def _search_core(self, k: int, *, rerank: int = 0, chunk: int = _CHUNK):
        """The search as ``(fn, arrays)``: ``fn(q, codes, row_sqn,
        codebooks[, corpus])`` with f32 queries ``q [Q, d]`` is
        :meth:`search`."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        rerank = int(rerank)
        if rerank and self._corpus is None:
            raise InvalidData("rerank requires keep_corpus=True at index construction")
        n = self.ntotal
        k_eff = min(int(k), n)
        fetch = min(max(k_eff, rerank), n)
        chunk = min(int(chunk), max(n, 1))
        metric = self.metric
        fused = (self.rq.num_centroids <= 256 and metric != "cosine"
                 and 1 <= fetch <= 128 and fetch < n)
        arrays = (self._codes, self._row_sqn, self.rq.codebooks) + (
            (self._corpus,) if rerank else ())

        def fn(q, codes, row_sqn, cbs, *rest):
            tables = torch.einsum("qd,skd->qsk", q, cbs)  # [Q, S, k]
            qn2 = (q * q).sum(-1)
            if fused:
                ids, d = _rq_scan_fused(tables, qn2, codes, row_sqn, fetch, metric)
            else:
                ids, d, _ = _rq_scan_chunked(tables, qn2, codes, row_sqn, metric, fetch, chunk)
            if rerank:
                return _rerank(q, ids, rest[0], metric, k_eff)
            return _top_values(ids, d, k_eff, metric)

        return fn, arrays

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded (approximate) vectors for stored ids."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        return self.rq.decode(self._codes[as_tensor(ids, self.device).to(torch.int64)])

    def _reconstruct_core(self):
        """:meth:`reconstruct` as ``(fn, arrays)``: ``fn(ids [N], codes)
        -> [N, d]`` f32."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        rq = self.rq

        def fn(ids, codes):
            return rq.decode(codes[as_tensor(ids, codes.device).to(torch.int64)])

        return fn, (self._codes,)

    def save(self, path: str) -> str:
        """Write the index (codebooks, codes, norms, kept corpus) as an
        ``rq_index`` ``.npz``."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "RQIndex":
        """Load an ``rq_index`` saved by either package onto ``device``."""
        return _load(path, "rq_index", device)

    def __repr__(self) -> str:
        return (
            f"RQIndex(ntotal={self.ntotal}, stages={self.rq.num_stages}, "
            f"k={self.rq.num_centroids}, metric={self.metric!r}, beam={self.beam})"
        )
