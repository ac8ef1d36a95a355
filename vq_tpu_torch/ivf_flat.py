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
rows. Not ported yet: ``range_search``, ``rebalance``, ``remove_ids``,
``merge_from``, ``search_and_reconstruct`` and ``_search_core``.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _flat_topk(d, ids, k: int):
    """Top-k ``(ids, values)`` over the flattened ``[Q, nprobe, rows]``
    probe (smaller is better; dead slots already at inf)."""
    nq = d.shape[0]
    vals, pos = _smallest(d.reshape(nq, -1), k)
    return torch.gather(ids.reshape(nq, -1), 1, pos), vals


class _IVFScanBase:
    """What IVF-Flat and IVF-SQ share: chunk-pool storage, occupancy
    stats and the probed search. A subclass names its payload
    (``_payload``, beside the ``sqn`` norms) and scores the probed rows
    (``_probe_distances``)."""

    _payload = ""
    _kind = ""

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

    def _matvec(self, lhs, probe, chains_s) -> torch.Tensor:
        """K6 over the probed chains: left vectors ``[Q, nprobe, d]`` (one
        a (query, list) pair) -> dots ``[Q, nprobe, rows]``."""
        nq, npr = probe.shape
        pool = self._pool
        return ivf_probe_matvec_fused(
            lhs.reshape(nq * npr, self.dim), chains_s[probe].reshape(nq * npr, -1),
            pool.data[self._payload], cap=pool.cap,
        ).reshape(nq, npr, -1)

    def _probe_distances(self, q, probe, qc, chains_s) -> torch.Tensor:
        raise NotImplementedError

    def _sqn(self, probe, chains_s) -> torch.Tensor:
        return take_list_payload(self._pool.data["sqn"], chains_s, probe)

    def search(self, queries, k: int = 10, *, nprobe: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [Q, k] i32, values [Q, k])`` over ``nprobe`` lists a
        query: squared-L2 distances ascending (inf pads) for
        ``metric="l2"``, inner products descending (-inf pads) for
        ``metric="dot"``; ids of -1 where the probed lists held fewer
        than k rows."""
        q = self._check_query(queries)
        if self._flat_lists is None:
            raise EmptyInput("index is empty — add() vectors first")
        k = int(k)
        pool = self._pool
        chains_s = pool.chains_search()
        nprobe = min(int(nprobe), self.nlist)
        k_eff = min(k, nprobe * chains_s.shape[1] * pool.ch)
        probe, qc = _coarse_probe(q, self.coarse, nprobe, self.metric)
        d = self._probe_distances(q, probe, qc, chains_s)
        ids = take_list_ids(pool.slot_ids, chains_s, probe, pool.cap)
        ids, dist = _pad_to_k(*_flat_topk(torch.where(ids >= 0, d, float("inf")), ids, k_eff), k)
        if self.metric == "dot":
            dist = -dist  # back to descending scores; pads become -inf
        return ids, dist

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

    def _probe_distances(self, q, probe, qc, chains_s):
        nq, npr = probe.shape
        qy = self._matvec(q[:, None, :].expand(nq, npr, self.dim), probe, chains_s)
        if self.metric == "dot":
            return -qy
        qn2 = (q * q).sum(-1)
        return torch.clamp_min(qn2[:, None, None] - 2.0 * qy + self._sqn(probe, chains_s), 0.0)

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

    def add(self, vectors) -> None:
        """Coarse-assign (K1), SQ-encode the residual and append a batch."""
        x = self._batch(vectors)
        lists, _ = assign(x, self.coarse)
        enc_in = x - self.coarse[lists.to(torch.int64)] if self.by_residual else x
        codes = self.sq.quantize(enc_in.to(torch.float32))
        y = self.sq.dequantize(codes)
        self._append(lists, {"codes": codes, "sqn": (y * y).sum(-1)})

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded rows for ids (residual decode plus the centroid)."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        pos = as_tensor(ids, self.device).to(torch.int64)
        y = self.sq.dequantize(self._pool.gather_rows("codes", pos))
        if self.by_residual:
            y = y + self.coarse[self._flat_lists[pos].to(torch.int64)]
        return y

    def _probe_distances(self, q, probe, qc, chains_s):
        nq, npr = probe.shape
        lo, step = self.sq.mins, self.sq.steps
        if self.metric == "dot":
            qs = (q * step)[:, None, :].expand(nq, npr, self.dim)
            qy = (q @ lo)[:, None, None] + self._matvec(qs, probe, chains_s)
            if self.by_residual:
                qy = qy + torch.gather(qc, 1, probe)[..., None]  # + q.c_list
            return -qy
        if self.by_residual:
            qr = q[:, None, :] - self.coarse[probe]
        else:
            qr = q[:, None, :].expand(nq, npr, self.dim)
        qry = (qr @ lo)[..., None] + self._matvec(qr * step, probe, chains_s)
        qrn2 = (qr * qr).sum(-1)
        return torch.clamp_min(qrn2[..., None] - 2.0 * qry + self._sqn(probe, chains_s), 0.0)

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

    def add(self, vectors) -> None:
        """Coarse-assign (K1), RQ-encode the residual and append a batch
        with ``||ŷ||^2`` and ``c_list.ŷ``."""
        x = self._batch(vectors).to(torch.float32)
        lists, _ = assign(x, self.coarse)
        c = self.coarse[lists.to(torch.int64)]
        codes = self.rq.encode(x - c if self.by_residual else x, beam=self.beam)
        y = self.rq.decode(codes)
        sqn = (y * y).sum(-1)
        cross = (c * y).sum(-1) if self.by_residual else torch.zeros_like(sqn)
        self._append(lists, {"codes": codes, "sqn": sqn, "cross": cross})

    def reconstruct(self, ids) -> torch.Tensor:
        """Decoded rows for ids (additive decode plus the centroid)."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        pos = as_tensor(ids, self.device).to(torch.int64)
        y = self.rq.decode(self._pool.gather_rows("codes", pos))
        if self.by_residual:
            y = y + self.coarse[self._flat_lists[pos].to(torch.int64)]
        return y

    def _probe_distances(self, q, probe, qc, chains_s):
        nq, npr = probe.shape
        pool = self._pool
        cbs = self.rq.codebooks
        tables = torch.einsum("qd,skd->qsk", q, cbs)  # [Q, S, k], probe-independent
        tab_rep = tables[:, None].expand(nq, npr, *tables.shape[1:]).reshape(nq * npr, *tables.shape[1:])
        tsum = ivf_probe_adc_fused(
            tab_rep, chains_s[probe].reshape(nq * npr, -1), pool.data["codes"], cap=pool.cap,
        ).reshape(nq, npr, -1)
        qc_sel = torch.gather(qc, 1, probe)  # [Q, np]
        if self.metric == "dot":
            return -(tsum + qc_sel[..., None]) if self.by_residual else -tsum
        qn2 = (q * q).sum(-1)
        if self.by_residual:
            cc = (self.coarse * self.coarse).sum(-1)
            qrn2 = (qn2[:, None] - 2.0 * qc_sel + cc[probe])[..., None]
        else:
            qrn2 = qn2[:, None, None]
        cross = take_list_payload(pool.data["cross"], chains_s, probe)
        return torch.clamp_min(qrn2 - 2.0 * (tsum - cross) + self._sqn(probe, chains_s), 0.0)

    def __repr__(self) -> str:
        return (
            f"IVFRQIndex(nlist={self.nlist}, ntotal={self.ntotal}, dim={self.dim}, "
            f"stages={self.rq.num_stages}, k={self.rq.num_centroids}, "
            f"residual={self.by_residual}, metric={self.metric!r}, beam={self.beam})"
        )
