"""IVF-Flat, IVF-SQ and IVF-RQ — the port of ``vq_tpu.ivf_flat``'s
``IVFFlatIndex``, ``IVFSQIndex`` and ``IVFRQIndex``, the faiss
``IndexIVFFlat`` / ``IndexIVFScalarQuantizer`` /
``IndexIVFResidualQuantizer`` analogs: a coarse k-means partition into
``nlist`` lists whose rows are stored raw (f32, or bf16 / f16 for half
the memory), as per-dimension SQ8 codes of the residual from the list's
centroid, or as RQ stage codes of that residual, plus exact norms a row.

* ``train`` — coarse k-means (``lloyd`` with k-means++ seeding: K2 each
  iteration, K1 for the final assignment); IVF-SQ then fits its
  per-dimension ranges on the residuals (or the raw rows), IVF-RQ trains
  its stage codebooks on them (:func:`rq_train`: K2 and K1 again).
* ``add`` — coarse assignment (K1), the row (or its SQ or RQ code) and its
  norms appended in place to the chunk pool (:mod:`vq_tpu_torch.ivf_pool`).
* ``search`` — the coarse scan (a plain fp32 matmul), the top-``nprobe``
  lists, K6 over the probed chunk chains at stored width (one left
  vector a (query, probed list) pair), the norm and affine terms added
  on ``[Q, nprobe, rows]``, and one stable top-k over every probed slot
  (``jax.lax.top_k``'s order: ascending, the lowest position first).

IVF-SQ decodes a stored code ``c`` to ``y = [c_list +] lo + step * c``.
With ``qr = q - c_list`` (``q`` without residual coding), the L2
distance is ``||qr||^2 - 2 (qr.lo + (qr*step).c) + ||y - c_list||^2`` and
the dot score ``[q.c_list +] q.lo + (q*step).c``: K6 computes the
``(qr*step).c`` term from the u8 codes, the rest is added outside.

IVF-RQ stores ``y = [c_list +] ŷ`` with ``ŷ = sum_s C_s[code_s]``, and
beside the codes ``||ŷ||^2`` and ``c_list.ŷ``. With tables ``T[q, s, j] =
q.C_s[j]`` of the raw query, ``(q - c_list).ŷ = sum T - c_list.ŷ``, so
the tables do not depend on the probe: K7 sums them over the probed
chains (one copy a (query, list) pair) and ``||q - y||^2 = ||q -
c_list||^2 - 2 (sum T - c_list.ŷ) + ||ŷ||^2`` is assembled outside, the
dot score as ``[q.c_list +] sum T``.

Values are squared-L2 distances (ascending, inf pads) for
``metric="l2"`` and inner products (descending, -inf pads) for
``metric="dot"``; ids of -1 mean the probed lists held fewer than k
rows. ``range_search`` takes the same probe (K6 or K7) and keeps the
best hits within the radius with their true count; ``_search_core``
gives a search as ``(fn, arrays)``.

Maintenance moves only the affected lists' chunks in the pool:

* ``remove_ids`` — the rows go, the rest renumber by position, and only
  the lists that held removed rows repack;
* ``merge_from`` — another index with the same coarse centroids and
  coding hands over its stored payloads as they are;
* ``rebalance`` — lists longer than a target are split by k-means
  (``lloyd``: K2, then K1) on a member subsample, short lists retire, and
  every affected row is reassigned (K1) and, where its coding depends on
  its list, re-encoded (IVF-SQ from its decoded row, IVF-RQ through the
  greedy encode's K1). The host orchestration (:func:`_rebalance_pass`)
  is the JAX package's, numpy included, so a split draws the same
  member subsample in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.convert import from_state
from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.ivf_pool import ChunkPool, bucket_stats, take_list_ids, take_list_payload
from vq_tpu_torch.models.base import (
    _HALF_DTYPES,
    as_tensor,
    check_training_matrix,
    resolve_device,
)
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.models.rq import ResidualQuantizer, rq_train
from vq_tpu_torch.models.sq import PerDimScalarQuantizer
from vq_tpu_torch.ops.cuda_kernels import ivf_probe_adc_fused, ivf_probe_matvec_fused
from vq_tpu_torch.ops.kmeans import assign, lloyd
from vq_tpu_torch.search import (
    _compact_rows,
    _merge_check,
    _removal_keep_mask,
    _search_and_reconstruct,
)
from vq_tpu_torch.utils.serialize import _from_npz, save

__all__ = ["IVFFlatIndex", "IVFSQIndex", "IVFRQIndex"]

_STORE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _coarse_probe(q, coarse, nprobe: int, metric: str):
    """Top-``nprobe`` lists a query -> ``(probe [Q, nprobe] i64, qc [Q,
    nlist])``: the smallest ``||c||^2 - 2 q.c`` for L2, the largest
    ``q.c`` for dot, the lowest list first on ties."""
    qc = q @ coarse.T
    scores = -qc if metric == "dot" else (coarse * coarse).sum(-1)[None, :] - 2.0 * qc
    return _smallest(scores, nprobe)[1], qc


def _pad_to_k(ids, dist, k: int):
    """The search contract's shape: ids of inf values become -1, and
    fewer than ``k`` results pad with -1 / inf."""
    ids = torch.where(torch.isinf(dist), -1, ids)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        dist = torch.nn.functional.pad(dist, (0, pad), value=float("inf"))
    return ids, dist


# Affected rows handled a block at a time during rebalance, so that the
# transient f32 member block (~1 GB at d = 128) never doubles the corpus.
_REBALANCE_BLOCK_ROWS = 2_097_152


def _list_members(lists_np: np.ndarray, nlist: int):
    """``members(l)``: the rows of list ``l`` in ascending order (one
    stable sort, so a loop over lists is not a scan of all rows a list)."""
    order = np.argsort(lists_np, kind="stable")
    bounds = np.searchsorted(lists_np[order], np.arange(nlist + 1))
    return lambda l: order[bounds[l]:bounds[l + 1]]


def _rebalance_pass(lists_np: np.ndarray, coarse_np: np.ndarray, nlist: int, member_vectors, *,
                    target_max, default_target: int, min_size: int, max_iters: int, seed: int):
    """One split / retire / compact / reassign pass over the lists, shared
    by every IVF index; host orchestration in numpy, as in the JAX
    package (``vq_tpu.ivf_flat._rebalance_pass``).

    Lists longer than ``target_max`` are split by k-means++ seeded
    ``lloyd`` (seed ``seed + 7 * i`` for the i-th split) on a member
    subsample drawn by ``np.random.default_rng(seed)``, part 0 taking the
    list's slot and the rest appended; lists shorter than ``min_size``
    (and, when ``min_size > 0``, empty ones) retire, and the ids compact.
    Every affected row is then reassigned by ``assign`` (K1) against the
    new centroids, in blocks of ``_REBALANCE_BLOCK_ROWS``.
    ``member_vectors(sorted rows) -> [len, d]`` f32 reads the index as it
    was before the pass. Returns None when nothing needs doing, else a
    dict with ``split``, ``retired``, ``coarse_new``, ``lists``, the
    affected ``rows`` (sorted) and their ``new_lists``, and ``remap_old``
    (old list -> new list, -1 retired)."""
    counts = np.bincount(lists_np, minlength=nlist)
    target_max = int(default_target if target_max is None else target_max)
    split_ids = np.where(counts > target_max)[0]
    retire_ids = np.setdiff1d(np.where((counts < int(min_size)) & (counts > 0))[0], split_ids)
    empty_retire = np.where(counts == 0)[0] if min_size > 0 else np.array([], int)
    if not (split_ids.size or retire_ids.size or empty_retire.size):
        return None

    rng = np.random.default_rng(int(seed))
    members = _list_members(lists_np, nlist)
    coarse = coarse_np.copy()
    keep = np.ones(nlist, bool)
    keep[retire_ids] = False
    keep[empty_retire] = False
    extra_centroids = []
    affected = [members(l) for l in split_ids]
    for li, l in enumerate(split_ids):
        rows = members(l)
        parts = int(-(-rows.size // target_max))
        sub_n = min(rows.size, max(target_max, 8 * parts))
        sub = rows if rows.size <= sub_n else rng.choice(rows, sub_n, replace=False)
        res = lloyd(member_vectors(np.sort(sub)), parts, max_iters=max_iters,
                    seed=seed + 7 * li, init="kmeans++")
        part_c = res.centroids.cpu().numpy()
        coarse[l] = part_c[0]  # part 0 keeps the list's slot
        if parts > 1:
            extra_centroids.append(part_c[1:])
    coarse_full = np.concatenate([coarse] + extra_centroids, axis=0) if extra_centroids else coarse
    affected += [members(l) for l in retire_ids]

    keep_full = np.ones(coarse_full.shape[0], bool)
    keep_full[:nlist] = keep
    remap = np.cumsum(keep_full) - 1  # old id -> new id
    coarse_new = coarse_full[keep_full]
    lists = remap[lists_np]

    rows = new_lists = None
    if affected:
        rows = np.unique(np.concatenate(affected))
        parts = []
        for s in range(0, rows.size, _REBALANCE_BLOCK_ROWS):
            xb = member_vectors(rows[s:s + _REBALANCE_BLOCK_ROWS])
            nlb, _ = assign(xb, torch.as_tensor(coarse_new, device=xb.device))
            parts.append(nlb.cpu().numpy())
        new_lists = np.concatenate(parts)
        lists[rows] = new_lists
    return {
        "split": int(split_ids.size),
        "retired": int(retire_ids.size + empty_retire.size),
        "coarse_new": coarse_new,
        "lists": lists,
        "rows": rows,
        "new_lists": new_lists,
        "remap_old": np.where(keep, remap[:nlist], -1).astype(np.int32),
    }


def _move_rows(pool: ChunkPool, out: dict, lists_np: np.ndarray, block_payloads) -> None:
    """Apply a rebalance pass to the pool, moving only the affected lists'
    chunks: ``block_payloads(rows, new_lists)`` gives each block's payloads
    from the pool as it was (re-encoded where the coding depends on the
    list); then the affected lists are freed, the lists relabelled, and
    the blocks appended under their own ids."""
    new_nlist = out["coarse_new"].shape[0]
    if out["rows"] is None:
        pool.relabel_lists(out["remap_old"], new_nlist)
        return
    rows_np, nl_np = out["rows"], out["new_lists"]
    blocks = []
    for s in range(0, rows_np.size, _REBALANCE_BLOCK_ROWS):
        rb, nlb = rows_np[s:s + _REBALANCE_BLOCK_ROWS], nl_np[s:s + _REBALANCE_BLOCK_ROWS]
        blocks.append((rb, nlb, block_payloads(rb, nlb)))
    pool.free_lists(np.unique(lists_np[rows_np]))
    pool.relabel_lists(out["remap_old"], new_nlist)
    for rb, nlb, pb in blocks:
        pool.append(nlb, pb, row_ids=rb)


def _default_target(max_list_size, counts: np.ndarray) -> int:
    """``rebalance``'s default ``target_max``: the list cap, else twice the
    mean list size (at least 8)."""
    return max_list_size or int(max(8, 2 * max(1.0, counts.mean())))


def _rebalance_rounds(once, target_max, min_size: int, max_iters: int, seed: int,
                      rounds: int) -> Tuple[int, int]:
    """Up to ``rounds`` passes of ``once`` (``min_size`` only in the first),
    until one splits and retires nothing -> ``(split, retired)`` summed."""
    total_split = total_retired = 0
    for r in range(max(1, int(rounds))):
        info = once(target_max=target_max, min_size=min_size if r == 0 else 0,
                    max_iters=max_iters, seed=seed + 1000 * r)
        total_split += info["split"]
        total_retired += info["retired"]
        if info["split"] == 0 and info["retired"] == 0:
            break
    return total_split, total_retired


def _range_hits(ids, d, radius: float, fetch: int, max_results: int, dot: bool):
    """``range_search``'s result from one probe's ``(ids, values)`` (smaller
    is better, dead slots at inf): a hit is ``value <= radius`` (``dot``
    values are negated scores, so the radius is negated too) on a live
    slot, so a NaN is never a hit. The best ``fetch`` hits in one stable
    sort, padded to ``max_results`` with -1 / inf (-inf scores for dot),
    and the true hit count of each query."""
    r = torch.tensor(-radius if dot else radius, dtype=torch.float32, device=d.device)
    hit = (d <= r) & (ids >= 0)
    counts = hit.sum(1, dtype=torch.int32)
    vals, pos = _smallest(torch.where(hit, d, float("inf")), fetch)
    ids = torch.gather(torch.where(hit, ids, -1), 1, pos)
    if ids.shape[1] < max_results:
        pad = max_results - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("inf"))
    return ids, (-vals if dot else vals), counts


class _IVFScanBase:
    """What the IVF indexes over the chunk pool share: storage, occupancy
    stats, the probed search and range search, and the lifecycle
    (``remove_ids``, ``merge_from``, ``rebalance``). A subclass names its
    payloads (``_payload_specs``; ``_scan_payloads``, the ones a search
    reads), scores the probed rows (``_probe_distances``), and says how a
    moved row is gathered (``_member_vectors``) and re-encoded against its
    new list (``_reencode_rows``)."""

    _payload = ""
    _kind = ""
    _scan_payloads: Tuple[str, ...] = ()
    # Whether _reencode_rows needs the member vectors; rows whose coding
    # does not depend on their list skip that gather during rebalance.
    _reencode_needs_x = True
    _merge_attrs: Tuple[str, ...] = ()
    _merge_arrays: Tuple[Tuple[str, str], ...] = ()  # (label, dotted attribute)

    def __init__(self, coarse_centroids, *, metric: str, max_list_size: Optional[int],
                 chunk_rows: int = 256, device=None):
        if metric not in ("l2", "dot"):
            raise InvalidParameter("metric", "must be 'l2' or 'dot'")
        self.metric = metric
        coarse = as_tensor(coarse_centroids, device).to(torch.float32)
        if coarse.ndim != 2 or coarse.shape[0] == 0:
            raise InvalidParameter("coarse_centroids", "expected a non-empty [nlist, d] matrix")
        self.coarse = coarse.contiguous()
        self.max_list_size = max_list_size
        self.chunk_rows = int(chunk_rows)
        self._pool: Optional[ChunkPool] = None
        self._flat_lists: Optional[torch.Tensor] = None  # [n] i32

    def _payload_specs(self) -> dict:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.coarse.device

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
        return ChunkPool(self._payload_specs(), self.nlist, chunk_rows=self.chunk_rows,
                         max_list_size=self.max_list_size, device=self.device)

    def _append(self, lists: torch.Tensor, payloads: dict) -> None:
        if self._pool is None:
            self._pool = self._new_pool()
        lists = lists.to(device=self.device, dtype=torch.int32)
        self._pool.append(lists, payloads)
        self._flat_lists = (
            lists if self._flat_lists is None else torch.cat([self._flat_lists, lists])
        )

    def reserve(self, rows: int) -> None:
        """Preallocate storage for ``rows`` total vectors, so each ``add``
        scatters in place without a doubling copy."""
        if self._pool is None:
            self._pool = self._new_pool()
        self._pool.reserve(int(rows))

    def bucket_stats(self) -> dict:
        """Occupancy: list-size distribution, searched capacity, and how
        many rows a ``max_list_size`` cap leaves unsearched."""
        if self._flat_lists is None:
            return {"ntotal": 0}
        return bucket_stats(self._pool, self.ntotal)

    def _batch(self, vectors) -> torch.Tensor:
        """An ``add`` batch as ``[n, d]`` on the index's device, f16 / bf16
        kept half and everything else f32."""
        x = as_tensor(vectors, self.device)
        if x.dtype not in _HALF_DTYPES:
            x = x.to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        return x

    def _check_query(self, queries) -> torch.Tensor:
        q = as_tensor(queries, self.device).to(torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=q.shape[1])
        return q

    # -- search ------------------------------------------------------------

    def _buckets(self) -> dict:
        """The search's view of the pool: the scanned payloads, ``ids``
        (the slot map), ``chains`` (cut to the search width) and
        ``coarse``."""
        pool = self._pool
        b = {name: pool.data[name] for name in self._scan_payloads}
        b.update(ids=pool.slot_ids, chains=pool.chains_search(), coarse=self.coarse)
        return b

    def _matvec(self, lhs, probe, b, cap: int) -> torch.Tensor:
        """K6 over the probed chains: left vectors ``[Q, nprobe, d]`` (one
        a (query, list) pair) -> dots ``[Q, nprobe, rows]``."""
        nq, npr = probe.shape
        return ivf_probe_matvec_fused(
            lhs.reshape(nq * npr, self.dim), b["chains"][probe].reshape(nq * npr, -1),
            b[self._payload], cap=cap,
        ).reshape(nq, npr, -1)

    def _probe_distances(self, q, probe, qc, b, cap: int) -> torch.Tensor:
        raise NotImplementedError

    def _probe(self, q, b, nprobe: int, cap: int):
        """The probed rows of each query -> ``(ids [Q, nprobe * rows] i32,
        values [Q, nprobe * rows])``, probe-rank major, smaller is better
        (dot scores negated), dead slots -1 / inf."""
        probe, qc = _coarse_probe(q, b["coarse"], nprobe, self.metric)
        d = self._probe_distances(q, probe, qc, b, cap)
        nq = q.shape[0]
        ids = take_list_ids(b["ids"], b["chains"], probe, cap).reshape(nq, -1)
        return ids, torch.where(ids >= 0, d.reshape(nq, -1), float("inf"))

    def search(self, queries, k: int = 10, *, nprobe: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [Q, k] i32, values [Q, k])`` over ``nprobe`` lists a
        query: squared-L2 distances ascending (inf pads) for
        ``metric="l2"``, inner products descending (-inf pads) for
        ``metric="dot"``; ids of -1 where the probed lists held fewer
        than k rows."""
        q = self._check_query(queries)
        fn, arrays = self._search_core(int(k), nprobe=nprobe)
        return fn(q, *arrays)

    def _search_core(self, k: int, *, nprobe: int = 8):
        """The search as ``(fn, arrays)``: ``fn(q, *arrays)`` with f32
        queries ``q [Q, d]`` is :meth:`search` (the pool's arrays and the
        coarse centroids are the arguments, sorted by name)."""
        if self._flat_lists is None:
            raise EmptyInput("index is empty — add() vectors first")
        b = self._buckets()
        names = tuple(sorted(b))
        k, cap = int(k), self._pool.cap
        nprobe = min(int(nprobe), self.nlist)
        k_eff = min(k, nprobe * b["chains"].shape[1] * b["ids"].shape[1])
        dot = self.metric == "dot"

        def fn(q, *arrs):
            ids, d = self._probe(q, dict(zip(names, arrs)), nprobe, cap)
            vals, pos = _smallest(d, k_eff)
            ids, dist = _pad_to_k(torch.gather(ids, 1, pos), vals, k)
            return (ids, -dist) if dot else (ids, dist)  # dot: descending scores, -inf pads

        return fn, tuple(b[n] for n in names)

    def range_search(self, queries, radius: float, *, nprobe: int = 8,
                     max_results: int = 1024) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every stored row within ``radius`` of each query among the
        probed lists (faiss's IVF contract: recall is bounded by the probe
        set) -> ``(ids, values, counts)``: the best ``max_results`` hits
        (-1 / inf pads, -inf scores for ``dot``) and the true number of
        probed hits a query. A hit is ``value <= radius`` for L2 and
        ``score >= radius`` for dot. The probe is the search's (K6 or K7)."""
        if self._flat_lists is None:
            raise EmptyInput("index is empty — add() vectors first")
        if int(max_results) < 1:
            raise InvalidParameter("max_results", "must be >= 1")
        b = self._buckets()
        q = self._check_query(queries)
        nprobe = min(int(nprobe), self.nlist)
        fetch = min(int(max_results), nprobe * b["chains"].shape[1] * b["ids"].shape[1])
        ids, d = self._probe(q, b, nprobe, self._pool.cap)
        return _range_hits(ids, d, float(radius), fetch, int(max_results), self.metric == "dot")

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the decoded vector of every hit -> ``(ids, values,
        vectors [Q, k, d])``; padded -1 ids give zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    # -- lifecycle ---------------------------------------------------------

    def remove_ids(self, ids) -> int:
        """Remove stored vectors by position; the rest renumber
        sequentially (faiss's ``remove_ids`` contract). Only the lists that
        held removed rows repack their chunks. Returns the count removed."""
        if self._flat_lists is None:
            raise EmptyInput("index is empty")
        mask = _removal_keep_mask(ids, self.ntotal, self.device)
        removed = np.where(~mask.cpu().numpy())[0]
        lists_np = self._flat_lists.cpu().numpy()
        (self._flat_lists,) = _compact_rows(mask, self._flat_lists)
        self._pool.remove(removed, lists_np)
        return int(removed.size)

    def merge_from(self, other) -> int:
        """Move every vector of ``other`` into this index (faiss IVF
        ``merge_from``): the same coarse centroids and coding, the stored
        payloads copied and never re-encoded, ``other`` left empty.
        Returns the count moved."""
        _merge_check(self, other, attrs=("metric", *self._merge_attrs),
                     arrays=(("coarse centroids", "coarse"), *self._merge_arrays))
        moved = other.ntotal
        if moved:
            self._append(other._flat_lists, other._pool.to_flat())
        other._flat_lists = None
        other._pool = None
        return moved

    def _member_vectors(self, rows: np.ndarray) -> torch.Tensor:
        """``[len(rows), d]`` f32 vectors of stored rows, for rebalance."""
        raise NotImplementedError

    def _reencode_rows(self, rows: np.ndarray, x, new_lists: np.ndarray, coarse_new: np.ndarray):
        """Payloads of moved rows under their new lists (None: unchanged)."""
        return None

    def rebalance(self, *, target_max: Optional[int] = None, min_size: int = 0,
                  max_iters: int = 8, seed: int = 0, rounds: int = 3) -> dict:
        """Split overfull lists and retire underfull ones: a search reads
        every probed list at the longest list's width, so skew taxes every
        query. Each list longer than ``target_max`` (default:
        ``max_list_size``, else twice the mean list size) is split by
        k-means on a member subsample, lists shorter than ``min_size``
        retire, and every affected row is reassigned to its nearest new
        centroid (K1) and re-encoded against it where its coding depends
        on the list (exact for raw rows; from the decoded rows otherwise,
        adding at most the quantization error already there). Up to
        ``rounds`` passes; ``min_size`` applies to the first. Returns
        ``{"split", "retired", "new_nlist"}``."""
        if self._flat_lists is None:
            raise EmptyInput("index is empty — add() vectors first")
        split, retired = _rebalance_rounds(self._rebalance_once, target_max, min_size,
                                           max_iters, seed, rounds)
        return {"split": split, "retired": retired, "new_nlist": self.nlist}

    def _rebalance_once(self, *, target_max, min_size, max_iters, seed) -> dict:
        lists_np = self._flat_lists.cpu().numpy()
        counts = np.bincount(lists_np, minlength=self.nlist)
        out = _rebalance_pass(
            lists_np, self.coarse.cpu().numpy(), self.nlist, self._member_vectors,
            target_max=target_max, default_target=_default_target(self.max_list_size, counts),
            min_size=min_size, max_iters=max_iters, seed=seed,
        )
        if out is None:
            return {"split": 0, "retired": 0, "new_nlist": self.nlist}
        pool = self._pool

        def block_payloads(rb, nlb):
            x = self._member_vectors(rb) if self._reencode_needs_x else None
            pb = self._reencode_rows(rb, x, nlb, out["coarse_new"]) or {}
            for name in pool.specs:
                if name not in pb:
                    pb[name] = pool.gather_rows(name, rb)
            return pb

        _move_rows(pool, out, lists_np, block_payloads)
        self.coarse = torch.as_tensor(out["coarse_new"], device=self.device).contiguous()
        self._flat_lists = torch.as_tensor(out["lists"].astype(np.int32), device=self.device)
        return {"split": out["split"], "retired": out["retired"], "new_nlist": self.nlist}

    def save(self, path: str) -> str:
        """Write the index as an ``.npz`` in the JAX package's format;
        returns the path."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None):
        """Load a checkpoint of this index kind saved by either package
        onto ``device``."""
        kind, config, arrays = _from_npz(path)
        if kind != cls._kind:
            raise InvalidData(f"expected an {cls._kind} checkpoint, got {kind!r}")
        return from_state(kind, config, arrays, device=device)


class IVFFlatIndex(_IVFScanBase):
    """Inverted-file index over raw rows: probed distances are exact,
    storage is d x 4 bytes a vector, or half that with
    ``store_dtype="bfloat16"`` / ``"float16"`` (distances are then exact
    for the stored, rounded rows)."""

    _payload = "rows"
    _kind = "ivfflat_index"
    _scan_payloads = ("rows", "sqn")
    _merge_attrs = ("store_dtype",)
    _reencode_needs_x = False  # raw rows do not depend on their list

    def __init__(self, coarse_centroids, *, metric: str = "l2", store_dtype: str = "float32",
                 max_list_size: Optional[int] = None, chunk_rows: int = 256, device=None):
        super().__init__(coarse_centroids, metric=metric, max_list_size=max_list_size,
                         chunk_rows=chunk_rows, device=device)
        if store_dtype not in _STORE_DTYPES:
            raise InvalidParameter("store_dtype", "must be 'float32', 'bfloat16', or 'float16'")
        self.store_dtype = store_dtype

    @classmethod
    def train(cls, training_data, nlist: int, *, max_iters: int = 10, seed: int = 42,
              metric: str = "l2", store_dtype: str = "float32",
              max_list_size: Optional[int] = None, spherical: bool = False,
              chunk_rows: int = 256, device=None) -> "IVFFlatIndex":
        """Fit the coarse partition (k-means++ seeded Lloyd, ``seed``) on
        the training data's device."""
        x = check_training_matrix(training_data, device)
        res = lloyd(x, nlist, max_iters=max_iters, seed=seed, init="kmeans++",
                    spherical=spherical)
        return cls(res.centroids, metric=metric, store_dtype=store_dtype,
                   max_list_size=max_list_size, chunk_rows=chunk_rows)

    def _payload_specs(self) -> dict:
        return {"rows": ((self.dim,), _STORE_DTYPES[self.store_dtype]),
                "sqn": ((), torch.float32)}

    def _append_rows(self, lists, rows) -> None:
        """Append rows at stored width with their norms, taken from the
        stored (possibly rounded) values so distances are exact for what
        the index holds."""
        rows = rows.to(_STORE_DTYPES[self.store_dtype])
        rf = rows.to(torch.float32)
        self._append(lists, {"rows": rows, "sqn": (rf * rf).sum(-1)})

    def add(self, vectors) -> None:
        """Coarse-assign (K1) and append a batch in place."""
        x = self._batch(vectors)
        lists, _ = assign(x, self.coarse)
        self._append_rows(lists, x)

    def reconstruct(self, ids) -> torch.Tensor:
        """Stored rows for ids, as f32 (exact up to ``store_dtype``)."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        return self._pool.gather_rows("rows", as_tensor(ids, self.device)).to(torch.float32)

    def _member_vectors(self, rows: np.ndarray) -> torch.Tensor:
        return self._pool.gather_rows("rows", rows).to(torch.float32)

    def _probe_distances(self, q, probe, qc, b, cap):
        nq, npr = probe.shape
        qy = self._matvec(q[:, None, :].expand(nq, npr, self.dim), probe, b, cap)
        if self.metric == "dot":
            return -qy
        qn2 = (q * q).sum(-1)
        sqn = take_list_payload(b["sqn"], b["chains"], probe)
        return torch.clamp_min(qn2[:, None, None] - 2.0 * qy + sqn, 0.0)

    def __repr__(self) -> str:
        return (
            f"IVFFlatIndex(nlist={self.nlist}, ntotal={self.ntotal}, dim={self.dim}, "
            f"metric={self.metric!r}, store_dtype={self.store_dtype!r})"
        )


class IVFSQIndex(_IVFScanBase):
    """Inverted-file index over per-dimension SQ8 codes: d bytes a vector
    plus one stored norm, exact distances to the decoded rows.
    ``by_residual=True`` (the default) codes ``x - coarse_centroid(x)``,
    whose per-dimension ranges are tighter."""

    _payload = "codes"
    _kind = "ivfsq_index"
    _scan_payloads = ("codes", "sqn")
    _merge_attrs = ("by_residual",)
    _merge_arrays = (("SQ lo", "sq.mins"), ("SQ hi", "sq.maxs"))

    def __init__(self, coarse_centroids, sq: PerDimScalarQuantizer, *, metric: str = "l2",
                 by_residual: bool = True, max_list_size: Optional[int] = None,
                 chunk_rows: int = 256, device=None):
        super().__init__(coarse_centroids, metric=metric, max_list_size=max_list_size,
                         chunk_rows=chunk_rows, device=device)
        if not isinstance(sq, PerDimScalarQuantizer):
            raise InvalidParameter("sq", "IVFSQIndex requires a PerDimScalarQuantizer")
        if sq.dim != self.dim:
            raise DimensionMismatch(expected=self.dim, found=sq.dim)
        self.sq = PerDimScalarQuantizer(sq.mins, sq.maxs, sq.levels, device=self.device)
        self.by_residual = bool(by_residual)

    @classmethod
    def train(cls, training_data, nlist: int, levels: int = 256, *, max_iters: int = 10,
              seed: int = 42, metric: str = "l2", by_residual: bool = True,
              max_list_size: Optional[int] = None, spherical: bool = False,
              device=None) -> "IVFSQIndex":
        """Fit the coarse partition, then per-dimension SQ ranges on the
        residuals (or on the raw vectors when ``by_residual=False``)."""
        x = check_training_matrix(training_data, device)
        res = lloyd(x, nlist, max_iters=max_iters, seed=seed, init="kmeans++",
                    spherical=spherical)
        sq_in = x - res.centroids[res.assignments.to(torch.int64)] if by_residual else x
        sq = PerDimScalarQuantizer.from_data(sq_in, levels)
        return cls(res.centroids, sq, metric=metric, by_residual=by_residual,
                   max_list_size=max_list_size)

    def _payload_specs(self) -> dict:
        return {"codes": ((self.dim,), torch.uint8), "sqn": ((), torch.float32)}

    def _encode_rows(self, x, lists, coarse) -> dict:
        """SQ codes of the residuals from ``coarse[lists]`` (or of the rows)
        and the decoded residuals' squared norms."""
        enc_in = x - coarse[lists.to(torch.int64)] if self.by_residual else x
        codes = self.sq.quantize(enc_in.to(torch.float32))
        y = self.sq.dequantize(codes)
        return {"codes": codes, "sqn": (y * y).sum(-1)}

    def add(self, vectors) -> None:
        """Coarse-assign (K1), SQ-encode the residual and append a batch."""
        x = self._batch(vectors)
        lists, _ = assign(x, self.coarse)
        self._append(lists, self._encode_rows(x, lists, self.coarse))

    def merge_from(self, other) -> int:
        if isinstance(other, IVFSQIndex) and self.sq.levels != other.sq.levels:
            raise InvalidData("cannot merge: SQ levels differ")
        return super().merge_from(other)

    def _member_vectors(self, rows: np.ndarray) -> torch.Tensor:
        # From the codes and the list's centroid before the rebalance.
        return self.reconstruct(rows)

    def _reencode_rows(self, rows, x, new_lists, coarse_new):
        dev = self.device
        return self._encode_rows(x, torch.as_tensor(new_lists, device=dev),
                                 torch.as_tensor(coarse_new, device=dev))

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded rows for ids (residual decode plus the centroid)."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        pos = as_tensor(ids, self.device).to(torch.int64)
        y = self.sq.dequantize(self._pool.gather_rows("codes", pos))
        if self.by_residual:
            y = y + self.coarse[self._flat_lists[pos].to(torch.int64)]
        return y

    def _probe_distances(self, q, probe, qc, b, cap):
        nq, npr = probe.shape
        lo, step = self.sq.mins, self.sq.steps
        if self.metric == "dot":
            qs = (q * step)[:, None, :].expand(nq, npr, self.dim)
            qy = (q @ lo)[:, None, None] + self._matvec(qs, probe, b, cap)
            if self.by_residual:
                qy = qy + torch.gather(qc, 1, probe)[..., None]  # + q.c_list
            return -qy
        if self.by_residual:
            qr = q[:, None, :] - b["coarse"][probe]
        else:
            qr = q[:, None, :].expand(nq, npr, self.dim)
        qry = (qr @ lo)[..., None] + self._matvec(qr * step, probe, b, cap)
        qrn2 = (qr * qr).sum(-1)
        sqn = take_list_payload(b["sqn"], b["chains"], probe)
        return torch.clamp_min(qrn2[..., None] - 2.0 * qry + sqn, 0.0)

    def __repr__(self) -> str:
        return (
            f"IVFSQIndex(nlist={self.nlist}, ntotal={self.ntotal}, dim={self.dim}, "
            f"levels={self.sq.levels}, residual={self.by_residual}, metric={self.metric!r})"
        )


class IVFRQIndex(_IVFScanBase):
    """Inverted-file index over additive residual-quantizer codes: S bytes
    a vector (k <= 256) plus two stored f32 terms a row, ``||ŷ||^2`` and
    ``c_list.ŷ``, which keep the search tables probe-independent. Probed
    distances are exact distances to the decoded rows. ``beam`` sets the
    encode at :meth:`add` (1 = greedy)."""

    _payload = "codes"
    _kind = "ivfrq_index"
    _scan_payloads = ("codes", "sqn", "cross")
    _merge_attrs = ("by_residual",)
    _merge_arrays = (("RQ codebooks", "rq.codebooks"),)

    def __init__(self, coarse_centroids, rq: ResidualQuantizer, *, metric: str = "l2",
                 by_residual: bool = True, beam: int = 1, max_list_size: Optional[int] = None,
                 chunk_rows: int = 256, device=None):
        device = resolve_device(device, coarse_centroids, getattr(rq, "codebooks", None))
        super().__init__(coarse_centroids, metric=metric, max_list_size=max_list_size,
                         chunk_rows=chunk_rows, device=device)
        if not isinstance(rq, ResidualQuantizer):
            raise InvalidParameter("rq", "IVFRQIndex requires a ResidualQuantizer")
        if rq.dim != self.dim:
            raise DimensionMismatch(expected=self.dim, found=rq.dim)
        if int(beam) < 1:
            raise InvalidParameter("beam", "must be >= 1")
        self.rq = ResidualQuantizer(codebooks=rq.codebooks, device=self.device)
        self.by_residual = bool(by_residual)
        self.beam = int(beam)

    @classmethod
    def train(cls, training_data, nlist: int, num_stages: int, num_centroids: int = 256, *,
              max_iters: int = 10, seed: int = 42, metric: str = "l2", by_residual: bool = True,
              beam: int = 1, max_list_size: Optional[int] = None, spherical: bool = False,
              device=None) -> "IVFRQIndex":
        """Fit the coarse partition (k-means++ seeded Lloyd, ``seed``), then
        the RQ stage codebooks on the residuals (or the raw rows when
        ``by_residual=False``)."""
        x = check_training_matrix(training_data, device)
        res = lloyd(x, nlist, max_iters=max_iters, seed=seed, init="kmeans++",
                    spherical=spherical)
        rq_in = x - res.centroids[res.assignments.to(torch.int64)] if by_residual else x
        cbs = rq_train(rq_in, num_stages, num_centroids, max_iters=max_iters, seed=seed)
        return cls(res.centroids, ResidualQuantizer(codebooks=cbs), metric=metric,
                   by_residual=by_residual, beam=beam, max_list_size=max_list_size)

    def _payload_specs(self) -> dict:
        code_dt = torch.uint8 if self.rq.num_centroids <= 256 else torch.int32
        return {"codes": ((self.rq.num_stages,), code_dt), "sqn": ((), torch.float32),
                "cross": ((), torch.float32)}

    def _encode_rows(self, x, lists, coarse) -> dict:
        """RQ codes of the residuals from ``coarse[lists]`` (or of the rows;
        K1 inside the greedy encode), ``||ŷ||^2`` and ``c_list.ŷ``."""
        c = coarse[lists.to(torch.int64)]
        codes = self.rq.encode(x - c if self.by_residual else x, beam=self.beam)
        y = self.rq.decode(codes)
        sqn = (y * y).sum(-1)
        cross = (c * y).sum(-1) if self.by_residual else torch.zeros_like(sqn)
        return {"codes": codes, "sqn": sqn, "cross": cross}

    def add(self, vectors) -> None:
        """Coarse-assign (K1), RQ-encode the residual and append a batch
        with ``||ŷ||^2`` and ``c_list.ŷ``."""
        x = self._batch(vectors).to(torch.float32)
        lists, _ = assign(x, self.coarse)
        self._append(lists, self._encode_rows(x, lists, self.coarse))

    def _member_vectors(self, rows: np.ndarray) -> torch.Tensor:
        # From the codes and the list's centroid before the rebalance.
        return self.reconstruct(rows)

    def _reencode_rows(self, rows, x, new_lists, coarse_new):
        dev = self.device
        return self._encode_rows(x, torch.as_tensor(new_lists, device=dev),
                                 torch.as_tensor(coarse_new, device=dev))

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded rows for ids (additive decode plus the centroid)."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        pos = as_tensor(ids, self.device).to(torch.int64)
        y = self.rq.decode(self._pool.gather_rows("codes", pos))
        if self.by_residual:
            y = y + self.coarse[self._flat_lists[pos].to(torch.int64)]
        return y

    def _probe_distances(self, q, probe, qc, b, cap):
        nq, npr = probe.shape
        cbs = self.rq.codebooks
        tables = torch.einsum("qd,skd->qsk", q, cbs)  # [Q, S, k], probe-independent
        tab_rep = tables[:, None].expand(nq, npr, *tables.shape[1:]).reshape(nq * npr, *tables.shape[1:])
        tsum = ivf_probe_adc_fused(
            tab_rep, b["chains"][probe].reshape(nq * npr, -1), b["codes"], cap=cap,
        ).reshape(nq, npr, -1)
        qc_sel = torch.gather(qc, 1, probe)  # [Q, np]
        if self.metric == "dot":
            return -(tsum + qc_sel[..., None]) if self.by_residual else -tsum
        qn2 = (q * q).sum(-1)
        if self.by_residual:
            coarse = b["coarse"]
            cc = (coarse * coarse).sum(-1)
            qrn2 = (qn2[:, None] - 2.0 * qc_sel + cc[probe])[..., None]
        else:
            qrn2 = qn2[:, None, None]
        cross = take_list_payload(b["cross"], b["chains"], probe)
        sqn = take_list_payload(b["sqn"], b["chains"], probe)
        return torch.clamp_min(qrn2 - 2.0 * (tsum - cross) + sqn, 0.0)

    def __repr__(self) -> str:
        return (
            f"IVFRQIndex(nlist={self.nlist}, ntotal={self.ntotal}, dim={self.dim}, "
            f"stages={self.rq.num_stages}, k={self.rq.num_centroids}, "
            f"residual={self.by_residual}, metric={self.metric!r}, beam={self.beam})"
        )
