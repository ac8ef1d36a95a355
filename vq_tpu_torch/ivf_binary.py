"""IVF-Binary — the port of ``vq_tpu.ivf_binary.IVFBinaryIndex``, the
faiss ``IndexBinaryIVF`` analog: packed sign bits (d/8 bytes a vector,
32 bits a uint32 word) in the IVF chunk pool.

* ``train`` — a float k-means partition of the raw vectors (``lloyd``
  with k-means++ seeding: K2 each iteration, K1 for the final
  assignment), probed with the coarse L2 scan of the other IVF indexes.
* ``add`` — coarse assignment (K1), the rows' sign bits packed
  (:meth:`BinaryQuantizer.quantize_packed`) and, with
  ``keep_corpus=True``, the float rows kept beside them in the pool.
* ``search`` — the top-``nprobe`` lists, then the Hamming count (XOR and
  the SWAR popcount of :mod:`vq_tpu_torch.models.bq`) of the packed query
  against every probed slot, one block of probe ranks at a time, so that
  the ``[Q, block x rows, words]`` XOR never spans every probe at once;
  one stable top-k over the probe-rank-major slots, which is the order of
  the JAX package's running ``lax.top_k`` merge over probe ranks, ties
  included. ``rerank=R`` re-scores the top R by exact squared L2 against
  the kept corpus. The JAX package scans with XLA (no Pallas kernel), so
  this scan is plain PyTorch on every device.
* ``range_search`` — every probed row within a Hamming radius, with the
  true counts; ``remove_ids``, ``merge_from`` (same threshold and
  ``keep_corpus``) and ``rebalance`` (which needs the kept corpus, the
  space the coarse centroids live in, and never re-encodes: packed bits
  do not depend on their list) as in :mod:`vq_tpu_torch.ivf_flat`.

Values are Hamming distances as f32 (ascending, inf pads), or exact
squared-L2 after a rerank. Checkpoints are the kind ``ivfbinary_index``
of either package; a ``keep_corpus`` checkpoint whose packed rows come
without their corpus raises :class:`InvalidData` (the JAX package's
loader fails there with ``KeyError('corpus')``, ``ROADMAP.md`` R4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import EmptyInput, InvalidData
from vq_tpu_torch.ivf_flat import _IVFScanBase, _pad_to_k
from vq_tpu_torch.ivf_pool import take_list_payload
from vq_tpu_torch.models.base import check_training_matrix
from vq_tpu_torch.models.bq import _HAMMING_CELLS, BinaryQuantizer, _popcount_, _words, packed_width
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.ops.kmeans import assign, lloyd

__all__ = ["IVFBinaryIndex"]


class IVFBinaryIndex(_IVFScanBase):
    """Inverted-file Hamming index over packed sign bits: d/8 bytes a
    vector, coarse-probed popcount scans, and an optional exact rerank
    from a kept float corpus."""

    _payload = "codes"
    _kind = "ivfbinary_index"
    _scan_payloads = ("codes",)
    _reencode_needs_x = False  # packed bits do not depend on their list

    def __init__(self, coarse_centroids, *, threshold: float = 0.0,
                 max_list_size: Optional[int] = None, keep_corpus: bool = False, device=None):
        super().__init__(coarse_centroids, metric="l2", max_list_size=max_list_size,
                         device=device)
        self.bq = BinaryQuantizer(threshold)
        self.keep_corpus = bool(keep_corpus)

    @classmethod
    def train(cls, training_data, nlist: int, *, threshold: float = 0.0, max_iters: int = 10,
              seed: int = 42, max_list_size: Optional[int] = None, keep_corpus: bool = False,
              spherical: bool = False, device=None) -> "IVFBinaryIndex":
        """Fit the coarse partition (k-means++ seeded Lloyd, ``seed``) on the
        raw float vectors, on the training data's device."""
        x = check_training_matrix(training_data, device)
        res = lloyd(x, nlist, max_iters=max_iters, seed=seed, init="kmeans++",
                    spherical=spherical)
        return cls(res.centroids, threshold=threshold, max_list_size=max_list_size,
                   keep_corpus=keep_corpus)

    @property
    def code_words(self) -> int:
        return packed_width(self.dim)

    def _payload_specs(self) -> dict:
        specs = {"codes": ((self.code_words,), torch.uint32)}
        if self.keep_corpus:
            specs["corpus"] = ((self.dim,), torch.float32)
        return specs

    def add(self, vectors) -> None:
        """Coarse-assign (K1), sign-pack and append a batch (with its float
        rows when the corpus is kept)."""
        x = self._check_query(vectors)
        lists, _ = assign(x, self.coarse)
        payloads = {"codes": self.bq.quantize_packed(x)}
        if self.keep_corpus:
            payloads["corpus"] = x
        self._append(lists, payloads)

    def merge_from(self, other) -> int:
        if isinstance(other, IVFBinaryIndex) and self.bq.threshold != other.bq.threshold:
            raise InvalidData("cannot merge: thresholds differ")
        if isinstance(other, IVFBinaryIndex) and self.keep_corpus != other.keep_corpus:
            raise InvalidData("cannot merge: keep_corpus differs")
        return super().merge_from(other)

    def rebalance(self, **kwargs) -> dict:
        # A split clusters the members in the coarse centroids' space, which
        # the packed bits are not: it needs the kept float rows.
        if not self.keep_corpus:
            raise InvalidData("rebalance requires keep_corpus=True for binary codes")
        return super().rebalance(**kwargs)

    def _member_vectors(self, rows: np.ndarray) -> torch.Tensor:
        return self._pool.gather_rows("corpus", rows)

    def _probe_distances(self, q, probe, qc, b, cap):
        nq, npr = probe.shape
        codes, chains = b["codes"], b["chains"]
        rows, words = chains.shape[1] * codes.shape[1], codes.shape[2]
        qp = _words(self.bq.quantize_packed(q))[:, None, None, :]
        out = torch.empty((nq, npr, rows), dtype=torch.float32, device=q.device)
        # int64 cells of one [Q, block x rows, words] XOR block, as BQ's
        # Hamming count blocks its own.
        cells = _HAMMING_CELLS.get(q.device.type, _HAMMING_CELLS["cuda"])
        block = max(1, cells // max(nq * rows * words, 1))
        for p0 in range(0, npr, block):
            x = _words(take_list_payload(codes, chains, probe[:, p0:p0 + block])) ^ qp
            out[:, p0:p0 + block] = _popcount_(x).sum(-1).to(torch.float32)
        return out

    def search(self, queries, k: int = 10, *, nprobe: int = 8,
               rerank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [Q, k] i32, Hamming distances [Q, k] f32)`` over the
        probed lists (ascending, -1 / inf pads). With ``rerank=R``: the top
        R by Hamming count re-ranked by exact squared L2 against the kept
        corpus (``keep_corpus=True``)."""
        q = self._check_query(queries)
        fn, arrays = self._search_core(int(k), nprobe=nprobe, rerank=rerank)
        return fn(q, *arrays)

    def _search_core(self, k: int, *, nprobe: int = 8, rerank: int = 0):
        """The search as ``(fn, arrays)``: ``fn(q, *arrays)`` is
        :meth:`search`; a rerank adds the pool's corpus and ``pos``."""
        if not rerank:
            return super()._search_core(k, nprobe=nprobe)
        if not self.keep_corpus:
            raise InvalidData("rerank requires keep_corpus=True at index construction")
        k = int(k)
        fetch = max(k, int(rerank))
        base_fn, base_arrays = super()._search_core(fetch, nprobe=nprobe)
        nb = len(base_arrays)

        def fn(q, *arrs):
            ids, _ = base_fn(q, *arrs[:nb])
            corpus_pool, pos = arrs[nb], arrs[nb + 1]
            corpus = corpus_pool.reshape(-1, corpus_pool.shape[-1])
            cand = corpus[pos[ids.clamp_min(0).to(torch.int64)].to(torch.int64)]  # [Q, R, d]
            exact = ((cand - q[:, None, :]) ** 2).sum(-1)
            exact = torch.where(ids >= 0, exact, float("inf"))
            vals, p = _smallest(exact, min(k, fetch))
            return _pad_to_k(torch.gather(ids, 1, p), vals, k)

        return fn, (*base_arrays, self._pool.data["corpus"], self._pool.pos)

    def reconstruct(self, ids) -> torch.Tensor:
        """The kept float rows for ids, or, without a corpus, the decoded
        low / high vectors."""
        if self._pool is None or self._pool.n_rows == 0:
            raise EmptyInput("index is empty")
        if self.keep_corpus:
            return self._pool.gather_rows("corpus", ids)
        return self.bq.dequantize_packed(self._pool.gather_rows("codes", ids), self.dim)

    def __repr__(self) -> str:
        return (
            f"IVFBinaryIndex(nlist={self.nlist}, ntotal={self.ntotal}, dim={self.dim}, "
            f"words={self.code_words}, keep_corpus={self.keep_corpus})"
        )
