"""GraphIndex: navigating-graph ANN search (the Vamana / DiskANN family,
the faiss ``IndexHNSW`` role) — the port of ``vq_tpu.graph``.

It keeps the JAX package's fixed-shape dataflow, in PyTorch on the card.

**Build** (:meth:`GraphIndex.build`):

1. k-NN candidates a node (:func:`_candidates`): exact
   (:func:`vq_tpu_torch.ops.knn.knn_graph`) up to ``exact_threshold``
   rows; above it the corpus queries its own bf16
   :class:`~vq_tpu_torch.ivf_flat.IVFFlatIndex` (K1 and K2 to train, K1
   to add, K6 for the sweep of every row at nprobe 8), query batches
   sized to a fixed device-memory budget.
2. The robust prune (:func:`_prune_all`): for a chunk of nodes, the
   ``[C, M, d]`` candidate rows, the ``[C, M, M]`` pairwise distances by
   one batched product, then the greedy dominance scan over the M ranks
   with ``[C, M]`` boolean state. A node's result does not depend on its
   chunk, so chunks are as large as a memory budget allows (a few tens
   of thousands of nodes, so a 1M build runs the scan ~30 times).
3. Reverse edges (:func:`_reverse_edges`): a stable sort of the flat
   edges by target and each edge's rank within its target, into a fixed
   ``[n, degree]`` table; the adjacency is forward ∪ reverse.

**Search** (:meth:`GraphIndex.search`): per-query entries from a routing
sample, then a batched best-first beam search with a ``[Q, L]`` pool, a
``[Q, T*B]`` visited list and T fixed expansion steps.

Every top-k keeps ``lax.top_k``'s order, the lowest position first on
ties (``models.pq._smallest``, a stable sort of ``d + 0.0``), and every
``jnp.argsort`` / ``jnp.lexsort`` is one or two stable sorts. The JAX
package's all-pairs id compares (duplicates, pool and visited
membership) become a stable sort a row and a sorted search, the same
masks at ``O(A log A)`` in place of ``O(A^2)``. Distances
are clamped by ``clamp_min(0.0)``, which keeps a -0.0 that
``jnp.maximum`` would turn into +0.0 (ROADMAP.md, R8); the squared
distances here are sums that cannot produce -0.0. The random draws
(long-range candidates, entry points, routing sample, the IVF training
sample) come from ``torch.Generator`` objects seeded from ``seed``, so a
seeded build matches the JAX package's in quality, not draw for draw.
L2 metric: for cosine, L2-normalize first (``NormalizeTransform``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.ops.kmeans import _generator
from vq_tpu_torch.utils.metrics import trace

__all__ = ["GraphIndex"]

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_INF = float("inf")
# Bytes of per-chunk temporaries (candidate rows, pairwise distances and
# their masks) the prune may take at once, and f32 values a query batch of
# the IVF candidate sweep may hold.
_PRUNE_BYTES = 2 << 30
_SWEEP_CELLS = 1 << 26
_SAMPLE_CAP = 4096  # routing-sample size
# New rows that beam-search the graph at once in ``add`` (a search step
# gathers ``[Q, 2 * degree * picks, d]`` rows).
_ADD_QUERIES = 8192
# Warn below this ratio (log-midpoint between the worst tight-cluster value
# 0.163 and the best smooth value 0.361 the JAX package records, with
# margin for sampling noise); below this many rows the statistic is too
# noisy and the question moot.
_CONCENTRATION_WARN = 0.25
_CONCENTRATION_MIN_ROWS = 10_000


def _chunk_nodes(m: int, d: int, chunk: Optional[int] = None) -> int:
    """Nodes a prune chunk of ``m`` candidates of ``d`` dims holds."""
    if chunk is not None:
        return max(1, int(chunk))
    return max(1, _PRUNE_BYTES // (4 * m * (m + d) + 2 * m * m))


def _sq_dists(node_rows, rows):
    """Squared L2 of each node ``[C, d]`` to its rows ``[C, M, d]`` ->
    ``[C, M]``, clamped at 0: ``||p||^2 - 2 p.r + ||r||^2``."""
    rn = (rows * rows).sum(-1)
    qy = torch.bmm(rows, node_rows[:, :, None])[..., 0]
    nn = (node_rows * node_rows).sum(-1)
    return torch.clamp_min(nn[:, None] - 2.0 * qy + rn, 0.0)


def _stable_order(d):
    """Row-wise stable ascending order of a float key (-0.0 equal to +0.0)."""
    return torch.sort(d + 0.0, dim=1, stable=True)[1]


def _later_duplicate(ids):
    """``[Q, A]`` mask of the entries whose id an earlier entry of the row
    holds: the JAX package's all-pairs test, by one stable sort a row."""
    order = torch.sort(ids, dim=1, stable=True)[1]
    s = torch.gather(ids, 1, order)
    dup = torch.cat([torch.zeros_like(s[:, :1], dtype=torch.bool), s[:, 1:] == s[:, :-1]], 1)
    return torch.zeros_like(dup).scatter_(1, order, dup)


def _member(ids, table):
    """``[Q, A]`` mask of the entries of ``ids`` found in the same row of
    ``table`` ``[Q, B]``: the all-pairs test, by a sort and a search."""
    t = torch.sort(table, dim=1).values
    pos = torch.searchsorted(t, ids).clamp_max(t.shape[1] - 1)
    return torch.gather(t, 1, pos) == ids


# ---------------------------------------------------------------------------
# Build: the vectorized robust prune.
# ---------------------------------------------------------------------------


def _augment_candidates_chunk(node_rows, node_ids, knn_ids, knn_d, rand_ids, rand_rows):
    """Merge k-NN candidates with random long-range ones, sorted by
    distance, with duplicates (and the node itself) masked out ->
    ``(ids [C, M], d [C, M])``, -1 / inf where masked.

    A pure k-NN graph over clustered data is disconnected: random
    candidates give the alpha-prune long edges to choose from, and with
    ``alpha > 1`` a faraway candidate is never dominated. -1 pads carry
    row 0's rows (callers gather at ``max(id, 0)``), so their distance is
    set to inf before the sort."""
    rd = _sq_dists(node_rows, rand_rows)
    rd = torch.where((rand_ids == node_ids[:, None]) | (rand_ids < 0), _INF, rd)
    cat_i = torch.cat([knn_ids.to(torch.int64), rand_ids.to(torch.int64)], 1)
    cat_d = torch.cat([knn_d.to(torch.float32), rd], 1)
    order = _stable_order(cat_d)
    si = torch.gather(cat_i, 1, order)
    sd = torch.gather(cat_d, 1, order)
    dup = _later_duplicate(si) & (si >= 0)
    sd = torch.where(dup, _INF, sd)
    si = torch.where(dup | torch.isinf(sd), -1, si)
    return si, sd


def _robust_prune_chunk(node_rows, cand_ids, cand_d, cand_rows, alpha2, r: int):
    """Vamana's robust prune for a chunk of nodes at once -> ``[C, r]``
    ids. Candidate ``v`` is pruned when a kept closer candidate ``u`` has
    ``alpha2 * d(u, v) <= d(p, v)`` (squared distances, so ``alpha2`` is
    alpha squared, an f32 tensor). Kept edges come first (distance
    order), then the pruned ones (distance order) to fill the list, pads
    last."""
    c, m = cand_ids.shape
    valid = cand_ids >= 0
    pd = _sq_dists_pairwise(cand_rows)
    ranks = torch.arange(m, device=cand_ids.device)
    later = ranks[None, :] > ranks[:, None]  # [j, v]: v after j
    pruned = ~valid
    keep = torch.zeros((c, m), dtype=torch.bool, device=cand_ids.device)
    for j in range(m):
        active = ~pruned[:, j] & valid[:, j]
        keep[:, j] = active
        dom = (alpha2 * pd[:, j, :] <= cand_d) & later[j][None, :]
        pruned = pruned | (dom & active[:, None])
    priority = torch.where(keep, ranks[None, :], ranks[None, :] + m)
    priority = torch.where(valid, priority, 3 * m)
    order = torch.sort(priority, dim=1, stable=True)[1][:, :r]
    out = torch.gather(cand_ids, 1, order)
    return torch.where(torch.gather(valid, 1, order), out, -1)


def _sq_dists_pairwise(rows):
    """``[C, M, M]`` squared L2 among each chunk's rows ``[C, M, d]``."""
    cc = (rows * rows).sum(-1)
    dots = torch.bmm(rows, rows.transpose(1, 2))
    return torch.clamp_min(cc[:, :, None] - 2.0 * dots + cc[:, None, :], 0.0)


def _ids_dist(node_rows, ids, rows):
    """Squared L2 of each node to its gathered rows, inf at -1 ids."""
    return torch.where(ids >= 0, _sq_dists(node_rows, rows), _INF)


def _prune_all(x, cand_ids, cand_d, rand_all, alpha2, r: int, r_far: int, chunk=None):
    """Augment + robust-prune every node, a chunk of nodes at a time ->
    the ``[n, r + r_far]`` forward adjacency (int64)."""
    n, d = x.shape
    m = cand_ids.shape[1] + rand_all.shape[1]
    c = _chunk_nodes(m, d, chunk)
    out = []
    for c0 in range(0, n, c):
        c1 = min(c0 + c, n)
        node_c = x[c0:c1]
        nid = torch.arange(c0, c1, device=x.device)
        rand_c = rand_all[c0:c1]
        ids_c, d_c = _augment_candidates_chunk(node_c, nid, cand_ids[c0:c1], cand_d[c0:c1],
                                               rand_c, x[rand_c.clamp_min(0)])
        part = _robust_prune_chunk(node_c, ids_c, d_c, x[ids_c.clamp_min(0)], alpha2, r)
        if r_far:
            far = rand_c[:, :r_far]
            part = torch.cat([part, torch.where(far == nid[:, None], -1, far)], 1)
        out.append(part)
    return torch.cat(out)


def _reverse_edges(fwd, n: int, cap: int):
    """``[n, R]`` forward edges -> ``[n, cap]`` reverse edges (who points
    at each node), each target's sources in flat edge order, the first
    ``cap`` kept, -1 pads."""
    r = fwd.shape[1]
    dev = fwd.device
    src = torch.arange(n, device=dev).repeat_interleave(r)
    dst = fwd.reshape(-1).to(torch.int64)
    lists = torch.where(dst >= 0, dst, n)  # -1 edges go to a scratch bucket n
    order = torch.sort(lists, stable=True)[1]
    sl = lists[order]
    counts = torch.bincount(lists, minlength=n + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sl.shape[0], device=dev) - starts[sl]
    kept = rank < cap
    rev = torch.full(((n + 1) * cap,), -1, dtype=torch.int64, device=dev)
    rev[(sl * cap + rank)[kept]] = src[order][kept]
    return rev.view(n + 1, cap)[:n]


def _candidates(x, r0: int, exact_threshold: int, seed: int):
    """``(ids [n, r0], d [n, r0])`` k-NN candidates of every row (the row
    itself excluded): exact up to ``exact_threshold`` rows, else through a
    temporary bf16 IVF-Flat index over the corpus (``nlist = max(64,
    2·⌊√n⌋)``, 8 Lloyd iterations on a random 200k-row sample, every row
    a query at nprobe 8)."""
    from vq_tpu_torch.ivf_flat import IVFFlatIndex
    from vq_tpu_torch.ops.knn import knn_graph

    n = x.shape[0]
    if n <= int(exact_threshold):
        ids, d = knn_graph(x, k=r0)
        return ids.to(torch.int64), d
    nlist = max(64, int(np.sqrt(n)) * 2)
    ns = min(n, 200_000)
    perm = torch.randperm(n, generator=_generator(int(seed) + 11, x.device), device=x.device)
    idx = IVFFlatIndex.train(x[perm[:ns]], nlist, max_iters=8, seed=seed, store_dtype="bfloat16")
    idx.add(x)
    fn, arrays = idx._search_core(r0 + 1, nprobe=8)
    pool = idx._pool
    width = 8 * pool.chains_search().shape[1] * pool.slot_ids.shape[1]
    qb = max(256, min(8192, _SWEEP_CELLS // max(width, 1)))
    out_i, out_d = [], []
    for q0 in range(0, n, qb):
        ids, vals = fn(x[q0:q0 + qb], *arrays)
        rows = torch.arange(q0, q0 + ids.shape[0], device=x.device)[:, None]
        keep = torch.where(ids == rows, _INF, vals)  # drop each row's own id
        order = _stable_order(keep)[:, :r0]
        out_i.append(torch.gather(ids.to(torch.int64), 1, order))
        out_d.append(torch.gather(keep, 1, order))
    return torch.cat(out_i), torch.cat(out_d)


def _concentration_stat(srows):
    """Mean 1-NN over mean pairwise Euclidean distance within a row sample
    (self-distance excluded): the cluster-concentration statistic behind
    the build's regime warning. On concentrated, well-separated clusters
    every sample point's 1-NN lies in its own cluster while the mean
    pairwise distance is set by the clusters' separation."""
    s = srows.shape[0]
    sq = (srows * srows).sum(-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (srows @ srows.T), 0.0)
    d2.fill_diagonal_(_INF)
    d1 = torch.sqrt(d2.min(1).values)
    inf = torch.isinf(d2)
    dmean = torch.where(inf, 0.0, torch.sqrt(torch.where(inf, 0.0, d2))).sum() / (s * (s - 1))
    return d1.mean() / dmean.clamp_min(1e-30)


# ---------------------------------------------------------------------------
# Search: the batched best-first beam.
# ---------------------------------------------------------------------------


def _entry_select(q, rows, sqn, sample, e_top: int):
    """Each query's ``e_top`` nearest routing-sample rows (one ``[Q, S]``
    product): a flattened HNSW hierarchy whose sample covers every basin,
    so the beam starts next to the answer."""
    d = sqn[sample][None, :] - 2.0 * (q @ rows[sample].to(torch.float32).T)
    return sample[_smallest(d, e_top)[1]]


def _graph_search(q, rows, sqn, graph, entry, k: int, L: int, T: int, B: int):
    """The beam search -> ``(ids [Q, k] i32, squared L2 [Q, k])``."""
    nq = q.shape[0]
    dev = q.device
    deg = graph.shape[1]
    qn2 = (q * q).sum(-1)

    def dist_to(ids):  # [Q, M] -> [Q, M] squared L2, inf at -1
        safe = ids.clamp_min(0)
        qy = torch.bmm(rows[safe].to(torch.float32), q[:, :, None])[..., 0]
        dd = qn2[:, None] - 2.0 * qy + sqn[safe]
        return torch.where(ids >= 0, torch.clamp_min(dd, 0.0), _INF)

    # The entry set, deduplicated once (sorted by (id, d), the best copy
    # kept); every step then keeps the pool free of duplicates by masking.
    e = min(entry.shape[1], L)
    pool_i = torch.full((nq, L), -1, dtype=torch.int64, device=dev)
    pool_i[:, :e] = entry[:, :e]
    pool_d = dist_to(pool_i)
    order = _stable_order(pool_d)
    order = torch.gather(order, 1, torch.sort(torch.gather(pool_i, 1, order), dim=1, stable=True)[1])
    si, sd = torch.gather(pool_i, 1, order), torch.gather(pool_d, 1, order)
    dup = torch.cat([torch.zeros((nq, 1), dtype=torch.bool, device=dev), si[:, 1:] == si[:, :-1]],
                    1) & (si >= 0)
    pool_d, pos = _smallest(torch.where(dup, _INF, sd), L)
    pool_i = torch.gather(torch.where(dup, -1, si), 1, pos)
    visited = torch.full((nq, T * B), -1, dtype=torch.int64, device=dev)
    bd = B * deg

    for t in range(T):
        seen = _member(pool_i, visited)
        open_d = torch.where(seen | (pool_i < 0), _INF, pool_d)
        best, sel = _smallest(open_d, B)
        picked_open = best < _INF
        picked = torch.where(picked_open, torch.gather(pool_i, 1, sel), -1)
        visited[:, t * B:(t + 1) * B] = picked
        nbrs = graph[picked.clamp_min(0)].to(torch.int64)
        nbrs = torch.where(picked_open[:, :, None], nbrs, -1).reshape(nq, bd)
        known = _member(nbrs, torch.cat([pool_i, visited], 1))
        fresh = ~(known | _later_duplicate(nbrs)) & (nbrs >= 0)
        nd = torch.where(fresh, dist_to(nbrs), _INF)
        cat_i = torch.cat([pool_i, torch.where(fresh, nbrs, -1)], 1)
        pool_d, pos = _smallest(torch.cat([pool_d, nd], 1), L)
        pool_i = torch.gather(cat_i, 1, pos)
    dist, pos = _smallest(pool_d, k)
    return torch.gather(pool_i, 1, pos).to(torch.int32), dist


def _run_search(q, rows, sqn, graph, sample, static_entry, ntotal: int, k: int, beam: int,
                   iters, picks_per_iter: int):
    """Parameter resolution, per-query entries, the beam search and the
    padding to k, shared by :meth:`GraphIndex.search` and its core."""
    L = max(beam, k)
    B = max(1, min(picks_per_iter, L))
    T = int(iters) if iters is not None else max(4, -(-3 * L // (2 * B)))
    k_eff = min(k, ntotal)
    e_top = min(8, int(sample.shape[0]))
    near = _entry_select(q, rows, sqn, sample.to(torch.int64), e_top)
    entry = torch.cat([near, static_entry.to(torch.int64)[None, :].expand(q.shape[0], -1)], 1)
    ids, dist = _graph_search(q, rows, sqn, graph, entry, k_eff, L, T, B)
    if k_eff < k:
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
        dist = torch.nn.functional.pad(dist, (0, k - k_eff), value=_INF)
    return ids, dist


class GraphIndex:
    """Navigable-graph ANN index (Vamana-style build, batched beam
    search), on the device of its rows. Build with :meth:`build`; ``add``
    inserts incrementally and ``remove_ids`` repairs the graph around the
    removed nodes.

    ``regime_warning`` (set by :meth:`build`, kept by :meth:`save`) is
    set when the corpus showed heavy cluster concentration at build time,
    the regime where beam search cannot recover the exact k-NN inside
    near-equidistant clusters and an IVF index is the right tool.
    """

    def __init__(self, rows, graph, entry, *, sample=None, store_dtype: str = "float32",
                 alpha: float = 1.2, regime_warning: Optional[str] = None, device=None):
        if store_dtype not in _STORE_DTYPES:
            raise InvalidParameter("store_dtype", "must be 'float32', 'bfloat16', or 'float16'")
        self._rows = as_tensor(rows, device).to(_STORE_DTYPES[store_dtype])
        dev = self._rows.device
        self.graph = as_tensor(graph, dev).to(torch.int32)
        self.entry = as_tensor(entry, dev).to(torch.int32).reshape(-1)
        self.sample = (as_tensor(sample, dev).to(torch.int32).reshape(-1)
                       if sample is not None else self.entry)
        self.store_dtype = store_dtype
        self.alpha = float(alpha)
        self.regime_warning = regime_warning or None
        rf = self._rows.to(torch.float32)
        self._sqn = (rf * rf).sum(-1)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, data, *, degree: int = 32, alpha: float = 1.2, knn_k: Optional[int] = None,
              store_dtype: str = "float32", exact_threshold: int = 200_000,
              prune_chunk: Optional[int] = None, seed: int = 0, device=None) -> "GraphIndex":
        """Build the pruned graph over ``data`` ``[n, d]`` on its device.

        ``degree`` bounds the forward edges a node (the adjacency is
        ``2*degree`` wide after the reverse-edge union); ``alpha > 1``
        keeps longer shortcut edges (Vamana's robustness knob); ``knn_k``
        is the candidate count a node (default ``2*degree``). Corpora
        larger than ``exact_threshold`` take their candidates from a
        temporary IVF-Flat index instead of the exact scan.
        ``prune_chunk`` sets the nodes a prune step holds (default: as
        many as a 2 GiB budget allows); the graph does not depend on it."""
        x = as_tensor(data, device).to(torch.float32)
        if x.ndim != 2 or x.shape[0] == 0:
            raise InvalidParameter("data", "expected a non-empty [n, d] array")
        n, d = x.shape
        dev = x.device
        degree = int(degree)
        if degree < 1:
            raise InvalidParameter("degree", "must be >= 1")
        if alpha < 1.0:
            raise InvalidParameter("alpha", "must be >= 1.0")
        if store_dtype not in _STORE_DTYPES:
            raise InvalidParameter("store_dtype", "must be 'float32', 'bfloat16', or 'float16'")
        r0 = int(knn_k) if knn_k is not None else min(2 * degree, n - 1)
        r0 = max(min(r0, n - 1), 1)
        r = min(degree, r0)

        with trace("vq_tpu_torch.graph.candidates"):
            cand_ids, cand_d = _candidates(x, r0, exact_threshold, seed)
        # Random long-range candidates (small-world shortcuts), a quarter
        # of the k-NN count.
        rr = max(4, r0 // 4)
        rand_all = torch.randint(0, n, (n, rr), generator=_generator(int(seed) + 1, dev),
                                 device=dev)
        # Reserved long edges: where clusters are tight against their
        # separation every near candidate survives the alpha test and the
        # budget fills before any shortcut, so a slice of it is random
        # (Kleinberg's small-world wiring). At least one pruned near edge
        # always remains.
        r_far = min(max(2, r // 8), rr, r - 1) if r >= 3 and n > r0 + 1 else 0
        # The dominance test runs on squared distances, so alpha enters squared.
        alpha2 = torch.tensor(float(alpha) ** 2, dtype=torch.float32, device=dev)
        with trace("vq_tpu_torch.graph.prune"):
            fwd = _prune_all(x, cand_ids, cand_d, rand_all, alpha2, r - r_far, r_far,
                             prune_chunk)
        with trace("vq_tpu_torch.graph.reverse_edges"):
            graph = torch.cat([fwd, _reverse_edges(fwd, n, r)], 1)

        # Entry points: the medoid and a few seeded random rows; the
        # routing sample: a seeded permutation's first rows.
        dd = ((x - x.mean(0, keepdim=True)) ** 2).sum(-1)
        medoid = _smallest(dd[None], 1)[1][0]
        extra = torch.randint(0, n, (min(15, n),), generator=_generator(int(seed) + 2, dev),
                              device=dev)
        entry = torch.cat([medoid, extra])
        s = min(_SAMPLE_CAP, n)
        sample = torch.randperm(n, generator=_generator(int(seed) + 3, dev), device=dev)[:s]

        # The regime guardrail: on heavily concentrated clusters a graph
        # silently caps recall@k well below an IVF index's, so measure the
        # concentration on the routing sample and warn.
        regime_warning = None
        if n >= _CONCENTRATION_MIN_ROWS:
            ratio = float(_concentration_stat(x[sample[:min(2048, s)]]))
            if ratio < _CONCENTRATION_WARN:
                regime_warning = (
                    f"corpus shows heavy cluster concentration (sample mean 1-NN / mean "
                    f"pairwise distance ratio {ratio:.2f} < {_CONCENTRATION_WARN}): graph "
                    "beam search cannot recover the exact k-NN inside near-equidistant "
                    "clusters and recall@k will silently degrade. An IVF index (e.g. "
                    f"index_factory(d, 'IVF{max(int(n ** 0.5), 1)},Flat')) scans whole "
                    "clusters exactly and is the right tool for this distribution."
                )
                import warnings

                warnings.warn(regime_warning, RuntimeWarning, stacklevel=2)
        return cls(x.to(_STORE_DTYPES[store_dtype]), graph, entry, sample=sample,
                   store_dtype=store_dtype, alpha=alpha, regime_warning=regime_warning)

    # -- queries ------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._rows.device

    @property
    def ntotal(self) -> int:
        return int(self._rows.shape[0])

    @property
    def dim(self) -> int:
        return int(self._rows.shape[1])

    @property
    def degree(self) -> int:
        return int(self.graph.shape[1])

    def search(self, queries, k: int = 10, *, beam: int = 64, iters: Optional[int] = None,
               picks_per_iter: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [Q, k] i32, squared L2 [Q, k])`` by the batched
        beam search.

        ``beam`` (L) is the candidate-pool width, the recall knob;
        ``iters`` the expansion steps (default ``ceil(1.5 * beam /
        picks_per_iter)``, enough to visit ~1.5 L nodes, at least 4);
        ``picks_per_iter`` (B) trades sequential steps for a wider
        expansion a step."""
        q = as_tensor(queries, self.device).to(torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=q.shape[1])
        fn, arrays = self._search_core(int(k), beam=beam, iters=iters,
                                       picks_per_iter=picks_per_iter)
        return fn(q, *arrays)

    def _search_core(self, k: int, *, beam: int = 64, iters: Optional[int] = None,
                     picks_per_iter: int = 8):
        """The search as ``(fn, arrays)`` with ``fn(q, *arrays)``:
        :meth:`search` is one call of it, and
        :class:`vq_tpu_torch.serving.BatchPipeline` loops it over batches."""
        if self.ntotal == 0:
            raise EmptyInput("index is empty")
        n, k, beam, picks = self.ntotal, int(k), int(beam), int(picks_per_iter)

        def fn(q, rows, sqn, graph, sample, entry):
            return _run_search(q, rows, sqn, graph, sample, entry, n, k, beam, iters, picks)

        return fn, (self._rows, self._sqn, self.graph, self.sample, self.entry)

    def reconstruct(self, ids) -> torch.Tensor:
        """Stored rows for ``ids``, as f32."""
        return self._rows[as_tensor(ids, self.device).to(torch.int64)].to(torch.float32)

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the stored rows of every hit -> ``(ids, values,
        vectors [Q, k, d])``; padded -1 ids give zero rows."""
        from vq_tpu_torch.search import _search_and_reconstruct

        return _search_and_reconstruct(self, queries, k, **kw)

    # -- mutation -------------------------------------------------------------

    def _repair(self, graph_all, rows_all, nodes, adj, extra, alpha2, width: int, chunk):
        """Re-prune the lists of ``nodes`` from their adjacency ``adj`` and
        candidates ``extra`` (both ``[A, *]``, -1 pads): the union, nearest
        first, keeps its first ``width`` where it fits, and goes through
        the dominance prune only where it overflows (re-pruning an
        underfull list could evict the reserved shortcut edges)."""
        m = adj.shape[1] + extra.shape[1]
        c = _chunk_nodes(m, self.dim, chunk)
        for s0 in range(0, nodes.shape[0], c):
            sl = slice(s0, s0 + c)
            v, a, b = nodes[sl], adj[sl], extra[sl]
            node_rows = rows_all[v].to(torch.float32)
            adj_d = _ids_dist(node_rows, a, rows_all[a.clamp_min(0)].to(torch.float32))
            si, sd = _augment_candidates_chunk(node_rows, v, a, adj_d, b,
                                               rows_all[b.clamp_min(0)].to(torch.float32))
            pruned = _robust_prune_chunk(node_rows, si, sd,
                                         rows_all[si.clamp_min(0)].to(torch.float32), alpha2, width)
            overflow = (si >= 0).sum(1) > width
            graph_all[v] = torch.where(overflow[:, None], pruned, si[:, :width]).to(graph_all.dtype)

    def add(self, vectors, *, ef: int = 128, chunk: Optional[int] = None) -> None:
        """Incremental insertion (the faiss HNSW ``add`` contract).

        Each new point beam-searches the existing graph for candidates
        (``ef``, the efConstruction analog), merges in its exact
        neighbours within the batch, alpha-prunes the union to its forward
        edges, and links back into its chosen neighbours' lists, nearest
        sources first and at most the list width a node, re-pruned where
        they overflow. The routing sample takes a proportional slice of
        the new ids. ``chunk`` sets the nodes a prune step holds."""
        from vq_tpu_torch.ops.knn import knn_graph

        x = as_tensor(vectors, self.device).to(torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] == 0:
            raise InvalidParameter("vectors", "expected a non-empty [n, d] batch")
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        dev = self.device
        n0, nb = self.ntotal, int(x.shape[0])
        w = self.degree
        alpha2 = torch.tensor(self.alpha ** 2, dtype=torch.float32, device=dev)

        # Candidates from the existing graph (one batched beam search), and
        # the exact neighbours within the batch, offset into the new ids.
        k_old = min(w, n0)
        found = [self.search(x[s0:s0 + _ADD_QUERIES], k=k_old, beam=max(int(ef), k_old))
                 for s0 in range(0, nb, _ADD_QUERIES)]
        ids_old = torch.cat([f[0] for f in found])
        d_old = torch.cat([f[1] for f in found])
        if nb >= 2:
            ib_ids = knn_graph(x, k=min(w, nb - 1))[0].to(torch.int64)
            ib_ids = torch.where(ib_ids >= 0, ib_ids + n0, -1)
        else:
            ib_ids = torch.full((nb, 0), -1, dtype=torch.int64, device=dev)
        rows_all = torch.cat([self._rows, x.to(_STORE_DTYPES[self.store_dtype])])
        new_ids = torch.arange(n0, n0 + nb, device=dev)

        fwd_parts = []
        c = _chunk_nodes(ids_old.shape[1] + ib_ids.shape[1], self.dim, chunk)
        for s0 in range(0, nb, c):
            sl = slice(s0, s0 + c)
            si, sd = _augment_candidates_chunk(
                x[sl], new_ids[sl], ids_old[sl], d_old[sl], ib_ids[sl],
                rows_all[ib_ids[sl].clamp_min(0)].to(torch.float32))
            fwd_parts.append(_robust_prune_chunk(
                x[sl], si, sd, rows_all[si.clamp_min(0)].to(torch.float32), alpha2, w))
        fwd_new = torch.cat(fwd_parts)
        graph_all = torch.cat([self.graph, fwd_new.to(torch.int32)])

        # Backlinks: the (new -> v) edges grouped by v, nearest source
        # first, capped at the list width, then each affected list merged
        # with them (re-pruned where it overflows).
        src = new_ids.repeat_interleave(w)
        dst = fwd_new.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        if dst.numel():
            ed = torch.empty(dst.shape[0], dtype=torch.float32, device=dev)
            for s0 in range(0, dst.shape[0], 262_144):
                a = rows_all[src[s0:s0 + 262_144]].to(torch.float32)
                b = rows_all[dst[s0:s0 + 262_144]].to(torch.float32)
                ed[s0:s0 + 262_144] = ((a - b) ** 2).sum(-1)
            order = torch.sort(ed + 0.0, stable=True)[1]
            order = order[torch.sort(dst[order], stable=True)[1]]
            src, dst = src[order], dst[order]
            vs, counts = torch.unique_consecutive(dst, return_counts=True)
            starts = torch.cumsum(counts, 0) - counts
            group = torch.repeat_interleave(torch.arange(vs.shape[0], device=dev), counts)
            posn = torch.arange(dst.shape[0], device=dev) - starts[group]
            sel = posn < w
            back = torch.full((vs.shape[0], w), -1, dtype=torch.int64, device=dev)
            back[group[sel], posn[sel]] = src[sel]
            self._repair(graph_all, rows_all, vs, graph_all[vs].to(torch.int64), back, alpha2, w,
                         chunk)

        # Routing sample: a proportional slice of the new ids, capped.
        take = min(nb, max(1, int(np.ceil(_SAMPLE_CAP * nb / (n0 + nb)))))
        picks = torch.randperm(nb, generator=_generator(n0 + nb, dev), device=dev)[:take] + n0
        sample = torch.cat([self.sample.to(torch.int64), picks])
        if sample.shape[0] > _SAMPLE_CAP:
            keep = torch.randperm(sample.shape[0], generator=_generator(n0, dev), device=dev)
            sample = sample[keep[:_SAMPLE_CAP]]

        self._rows = rows_all
        self.graph = graph_all
        self.sample = sample.to(torch.int32)
        # Norms of the stored-width rows, as __init__ and load take them.
        xs = x.to(_STORE_DTYPES[self.store_dtype]).to(torch.float32)
        self._sqn = torch.cat([self._sqn, (xs * xs).sum(-1)])
        self._replica_cache = None  # the sharded search must copy the index again

    def merge_from(self, other) -> int:
        """Unsupported: a navigable graph's edges are global, so merging
        two graphs needs a rebuild (as in faiss HNSW). Build a
        ``GraphIndex`` on the union of the rows instead."""
        raise InvalidData(
            "GraphIndex does not support merge_from — rebuild from the union of the corpora")

    def remove_ids(self, ids, *, chunk: Optional[int] = None) -> int:
        """Positional removal with sequential renumbering (the faiss
        ``remove_ids`` contract), with the delete-repair of FreshDiskANN:
        every surviving node that pointed at a removed one is patched with
        candidates from that node's own surviving out-neighbours (bridging
        the hole), re-pruned to the list width where it overflows; then
        rows, adjacency, entries and routing sample compact and renumber.
        Returns the count removed."""
        from vq_tpu_torch.search import _removal_keep_mask

        if self.ntotal == 0:
            raise EmptyInput("index is empty")
        dev = self.device
        n0, w = self.ntotal, self.degree
        keep = _removal_keep_mask(ids, n0, dev)
        removed = n0 - int(keep.sum())
        if removed == 0:
            return 0
        alpha2 = torch.tensor(self.alpha ** 2, dtype=torch.float32, device=dev)
        g = self.graph.to(torch.int64)
        tgt_removed = (g >= 0) & ~keep[g.clamp_min(0)]
        aff = torch.nonzero(keep & tgt_removed.any(1))[:, 0]
        graph_all = self.graph.clone()
        rows32 = self._rows.to(torch.float32)
        c = _chunk_nodes(3 * w, self.dim, chunk)
        for s0 in range(0, aff.shape[0], c):
            a = aff[s0:s0 + c]
            # Bridge candidates of node u: graph[r] over u's removed
            # targets r, filtered to surviving nodes other than u, capped
            # at 2W (valid first, stable).
            rs = torch.where(tgt_removed[a], g[a], -1)
            br = g[rs.clamp_min(0)].reshape(a.shape[0], -1)
            br = torch.where((rs >= 0).repeat_interleave(w, dim=1), br, -1)
            valid = (br >= 0) & keep[br.clamp_min(0)] & (br != a[:, None])
            br = torch.where(valid, br, -1)
            order = torch.sort((~valid).to(torch.int8), dim=1, stable=True)[1]
            br = torch.gather(br, 1, order)[:, :2 * w]
            adj = torch.where(tgt_removed[a], -1, g[a])
            self._repair(graph_all, rows32, a, adj, br, alpha2, w, chunk)

        # Renumber and compact; -1 pads move right within each list.
        alive = torch.nonzero(keep)[:, 0]
        new_of = torch.full((n0,), -1, dtype=torch.int64, device=dev)
        new_of[alive] = torch.arange(alive.shape[0], device=dev)
        g_kept = graph_all[alive].to(torch.int64)
        ok = (g_kept >= 0) & keep[g_kept.clamp_min(0)]
        g_new = torch.where(ok, new_of[g_kept.clamp_min(0)], -1)
        g_new = torch.gather(g_new, 1, torch.sort((g_new < 0).to(torch.int8), dim=1,
                                                  stable=True)[1])
        self._rows = self._rows[alive]
        self._sqn = self._sqn[alive]
        self.graph = g_new.to(torch.int32)
        self._replica_cache = None  # the sharded search must copy the index again

        def remap(old, fallback_medoid: bool):
            if alive.shape[0] == 0:
                return torch.zeros((0,), dtype=torch.int32, device=dev)
            kept = new_of[old.to(torch.int64)]
            kept = kept[kept >= 0]
            if kept.shape[0] == 0:
                if fallback_medoid:
                    rf = self._rows.to(torch.float32)
                    kept = _smallest(((rf - rf.mean(0, keepdim=True)) ** 2).sum(-1)[None], 1)[1][0]
                else:
                    kept = torch.randperm(alive.shape[0], device=dev, generator=_generator(
                        alive.shape[0], dev))[:min(_SAMPLE_CAP, alive.shape[0])]
            return kept.to(torch.int32)

        self.entry = remap(self.entry, True)
        self.sample = remap(self.sample, False)
        return removed

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the index as a ``graph_index`` ``.npz`` in the JAX
        package's format (bf16 rows as their uint16 bits); returns the path."""
        from vq_tpu_torch.utils.serialize import save

        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "GraphIndex":
        """Load a ``graph_index`` checkpoint saved by either package."""
        from vq_tpu_torch.utils.serialize import load

        return load(path, device, expect="graph_index")

    def __repr__(self) -> str:
        return (f"GraphIndex(ntotal={self.ntotal}, dim={self.dim}, degree={self.degree}, "
                f"store_dtype={self.store_dtype!r})")


def _graph_state(idx: GraphIndex):
    """``(config, arrays)`` of a ``graph_index`` checkpoint."""
    rows = idx._rows.detach().cpu()
    rows = (rows.view(torch.int16).numpy().view(np.uint16) if idx.store_dtype == "bfloat16"
            else rows.numpy())
    return ({"store_dtype": idx.store_dtype, "alpha": idx.alpha,
             "regime_warning": idx.regime_warning or ""},
            {"rows": rows, "graph": idx.graph.cpu().numpy(), "entry": idx.entry.cpu().numpy(),
             "sample": idx.sample.cpu().numpy()})


def _graph_from(config, arrays, device) -> GraphIndex:
    rows = np.asarray(arrays["rows"])
    if config["store_dtype"] == "bfloat16":
        rows = torch.from_numpy(rows.astype(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return GraphIndex(rows, np.asarray(arrays["graph"]), np.asarray(arrays["entry"]),
                      sample=arrays.get("sample"), store_dtype=config["store_dtype"],
                      alpha=config.get("alpha", 1.2),
                      regime_warning=config.get("regime_warning") or None, device=device)
