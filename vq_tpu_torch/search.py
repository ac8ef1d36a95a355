"""Flat ADC search over PQ codes — the ``PQIndex`` of ``vq_tpu.search``.

``add`` encodes a batch (K4 on the card) and appends its codes; ``search``
is the flat ADC top-k (K5 on the card) with an optional exact rerank from
the kept raw corpus. Codes and corpus live on the quantizer's device.
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
from vq_tpu_torch.models.pq import ProductQuantizer
from vq_tpu_torch.ops.packing import bits_for, pack_codes, unpack_codes
from vq_tpu_torch.utils.serialize import _from_npz, save

__all__ = ["PQIndex"]


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
