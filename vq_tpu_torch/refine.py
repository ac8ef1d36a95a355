"""Refinement rerank — the port of ``vq_tpu.refine`` (the faiss
``IndexRefine`` / ``IndexRefineFlat`` / ``IndexIVFPQR`` role).

A base index fetches ``ceil(k_factor * k)`` candidates and a refinement
code stored beside it re-scores them:

========  ======================  ==========================  =========
refiner   codes                   reranks with                bytes/vec
========  ======================  ==========================  =========
"flat"    raw rows at a dtype     exact distances (f32) or    4d/2d
          (f32 / bf16 / f16)      near-exact (half widths)
"sq8"     per-dim scalar codes    SQ-decoded distances        d
PQ        residual-of-base-       base recon + PQ-decoded     m₂
          reconstruction codes    residual (IVFPQR)
========  ======================  ==========================  =========

The search is one function, :meth:`RefineIndex._search_core`: the base's
``_search_core(fetch)`` (its kernels: K5, K6 or K7 on the card), then the
code gather, decode (plus the base's ``_reconstruct_core`` for a
residual refiner), exact scores and one stable top-k, all plain PyTorch
on the card as they are XLA work in the JAX package. Training a residual
refiner (:meth:`RefineIndex.train_pq`) codes the training rows with the
base (K1 and K4 for IVF-PQ) and trains a PQ on the residuals (K3).

The final ranking is the JAX package's: ``"euclidean"`` candidates rank
by ``sqrt(d²)``, so two squared distances one ulp apart can round to the
same root and then rank by candidate position (``ROADMAP.md``, R9), and
the top-k is a stable sort with the lowest candidate position first on
ties. As everywhere in the port, every NaN ranks last and ±0.0 tie by
position (R8), where ``lax.top_k`` ranks by the float total order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.ivf import IVFPQIndex
from vq_tpu_torch.models.base import as_tensor
from vq_tpu_torch.models.pq import ProductQuantizer, _smallest, pq_train
from vq_tpu_torch.models.sq import PerDimScalarQuantizer
from vq_tpu_torch.ops.kmeans import assign
from vq_tpu_torch.search import (
    PQIndex,
    RQIndex,
    SQIndex,
    _concat_rows,
    _merge_check,
    _removal_keep_mask,
    _search_and_reconstruct,
)
from vq_tpu_torch.utils.serialize import load, save

__all__ = ["RefineIndex"]

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_METRICS = ("squared_euclidean", "euclidean", "cosine", "manhattan", "dot")


def _base_metric(base) -> str:
    """Any index's metric as a metric name for the exact re-scoring
    (smaller is better there; ``dot`` negated)."""
    m = getattr(base, "metric", None)
    if m == "l2":
        return "squared_euclidean"
    if m in _METRICS:
        return m
    pq = getattr(base, "pq", None)
    if pq is not None and hasattr(pq, "distance_metric"):
        return str(pq.distance_metric)
    return "squared_euclidean"  # BinaryIndex / IVFBinaryIndex


def _exact_scores(q: torch.Tensor, rec: torch.Tensor, metric: str) -> torch.Tensor:
    """Smaller-is-better scores of ``rec [Q, R, d]`` against ``q [Q, d]``,
    the JAX package's formulas (``dot`` negated)."""
    q = q[:, None, :].to(torch.float32)
    rec = rec.to(torch.float32)
    if metric == "dot":
        return -(rec * q).sum(-1)
    if metric == "manhattan":
        return (rec - q).abs().sum(-1)
    if metric == "cosine":
        num = (rec * q).sum(-1)
        den = torch.clamp_min(
            torch.sqrt((rec * rec).sum(-1)) * torch.sqrt((q * q).sum(-1)), 1e-10)
        return 1.0 - torch.clamp(num / den, -1.0, 1.0)
    d2 = ((rec - q) ** 2).sum(-1)
    if metric == "euclidean":
        return torch.sqrt(d2)  # R9: the reference ranks by the root
    return d2


class RefineIndex:
    """Rerank any base index from a compact refinement code.

    ::

        base = IVFPQIndex.train(x, 256, 8)          # 8 B/vec
        idx = RefineIndex(base, refiner="sq8")       # +128 B/vec
        idx.add(x)
        ids, d = idx.search(q, k=10, k_factor=4, nprobe=8)

    ``refiner``: ``"flat"`` (raw rows at ``store_dtype``), ``"sq8"``
    (per-dimension scalar codes, ranges fitted on the first :meth:`add`
    batch unless ``sq_train_data`` is given), or a trained
    :class:`~vq_tpu_torch.models.pq.ProductQuantizer` coding the residual
    ``x - base_reconstruction(x)`` (:meth:`train_pq`; the base needs
    ``_reconstruct_core``: PQIndex, SQIndex, RQIndex or IVFPQIndex).

    Values are exact distances to the refined reconstruction under the
    base's metric (``dot`` gives descending scores, ``-inf`` pads). The
    codes live on the base's device.

    Caveat (residual refiners): the codes are residuals of the base's
    stored reconstructions, so an operation that re-encodes the base in
    place (``IVFPQIndex.rebalance``) stales them. Rebalance the base
    before wrapping it, or re-add through the wrapper.
    """

    def __init__(self, base, refiner="flat", *, store_dtype: str = "float32",
                 levels: int = 256, sq_train_data=None, metric: Optional[str] = None):
        if not hasattr(base, "_search_core"):
            raise InvalidParameter(
                "base", f"{type(base).__name__} does not expose a search core")
        self.base = base
        self.metric = metric if metric is not None else _base_metric(base)
        if self.metric not in _METRICS:
            raise InvalidParameter("metric", f"unknown metric {self.metric!r}")
        self._codes: Optional[torch.Tensor] = None
        self.sq = None
        self.refine_pq = None
        if isinstance(refiner, str) and refiner == "flat":
            self.kind = "flat"
            self.residual = False
            if store_dtype not in _STORE_DTYPES:
                raise InvalidParameter("store_dtype", f"must be one of {sorted(_STORE_DTYPES)}")
            self.store_dtype = store_dtype
        elif isinstance(refiner, str) and refiner == "sq8":
            self.kind = "sq8"
            self.residual = False
            self.store_dtype = None
            self.levels = int(levels)
            if sq_train_data is not None:
                self.sq = PerDimScalarQuantizer.from_data(
                    as_tensor(sq_train_data, self.device), self.levels)
        elif hasattr(refiner, "encode") and hasattr(refiner, "decode"):
            if not hasattr(base, "_reconstruct_core"):
                raise InvalidParameter(
                    "base", "residual (PQ) refinement needs a base with _reconstruct_core "
                    f"(PQIndex / SQIndex / RQIndex / IVFPQIndex), not {type(base).__name__}")
            self.kind = "pq"
            self.residual = True
            self.store_dtype = None
            self.refine_pq = refiner
            if refiner.dim != self.dim:
                raise DimensionMismatch(expected=self.dim, found=refiner.dim)
        else:
            raise InvalidParameter("refiner", "must be 'flat', 'sq8', or a trained ProductQuantizer")
        if base.ntotal:
            raise InvalidData(
                "base index already holds vectors — RefineIndex must see every add() to "
                "store the matching refinement codes")

    # -- construction --------------------------------------------------------

    @classmethod
    def train_pq(cls, base, training_data, num_subspaces: int = 16, num_centroids: int = 256, *,
                 max_iters: int = 10, seed: int = 42, metric: Optional[str] = None) -> "RefineIndex":
        """Fit an IVFPQR-style residual refiner: a PQ trained on ``x -
        base_coding(x)`` over ``training_data`` (the base trained and
        empty). ``num_subspaces`` is the faiss ``M_refine``."""
        x = as_tensor(training_data, getattr(base, "device", None)).to(torch.float32)
        res = x - _codec_approx(base, x)
        cbs = pq_train(res, num_subspaces, num_centroids, max_iters=max_iters, seed=seed)
        return cls(base, ProductQuantizer(codebooks=cbs, distance="squared_euclidean"),
                   metric=metric)

    # -- delegated surface ---------------------------------------------------

    @property
    def dim(self) -> int:
        return int(self.base.dim)

    @property
    def ntotal(self) -> int:
        return int(self.base.ntotal)

    @property
    def device(self) -> Optional[torch.device]:
        return getattr(self.base, "device", None)

    @property
    def code_bytes_per_vector(self) -> int:
        """Refinement bytes per vector (on top of the base's codes)."""
        if self.kind == "flat":
            return self.dim * (4 if self.store_dtype == "float32" else 2)
        if self.kind == "sq8":
            return self.dim
        return self.refine_pq.num_subspaces

    # -- data ----------------------------------------------------------------

    def add(self, vectors) -> None:
        """Add to the base index and store the refinement codes of the
        same rows (positions stay aligned)."""
        raw = as_tensor(vectors, self.device)
        x = raw.to(torch.float32)
        if x.ndim == 1:
            raw, x = raw[None, :], x[None, :]
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        n0 = self.base.ntotal
        self.base.add(raw)
        if self.residual:
            # The residual of what the base stored: decode the new rows.
            ids = torch.arange(n0, self.base.ntotal, device=x.device)
            target = x - self.base.reconstruct(ids)
        else:
            target = x
        codes = self._encode(target)
        self._codes = codes if self._codes is None else torch.cat([self._codes, codes])

    def _encode(self, target: torch.Tensor) -> torch.Tensor:
        if self.kind == "flat":
            return target.to(_STORE_DTYPES[self.store_dtype])
        if self.kind == "sq8":
            if self.sq is None:
                self.sq = PerDimScalarQuantizer.from_data(target, self.levels)
            return self.sq.quantize(target)
        return self.refine_pq.encode(target)

    def remove_ids(self, ids) -> int:
        """Positional removal with sequential renumbering; the refine
        codes stay aligned with the base."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        mask = _removal_keep_mask(ids, self.ntotal, self._codes.device)
        removed = self.base.remove_ids(ids)
        self._codes = self._codes[mask]
        return removed

    def merge_from(self, other: "RefineIndex") -> int:
        """Move ``other``'s vectors (and refine codes) into this index:
        the same refiner kind and fitted state."""
        arrays = ()
        if self.kind == "sq8" and other.kind == "sq8":
            if self.sq is None and other.sq is not None:
                # An unfitted (so empty) self adopts other's quantizer:
                # other's codes decode with its ranges.
                self.sq = other.sq
            if self.sq is not None and other.sq is not None:
                arrays = (("SQ mins", "sq.mins"), ("SQ steps", "sq.steps"))
            elif other._codes is not None:
                raise InvalidData("cannot merge: other holds SQ codes but no fitted quantizer")
        elif self.kind == "pq" and other.kind == "pq":
            arrays = (("refine PQ codebooks", "refine_pq.codebooks"),)
        _merge_check(self, other, attrs=("kind", "residual", "store_dtype", "metric"),
                     arrays=arrays)
        moved = self.base.merge_from(other.base)
        self._codes = _concat_rows(self._codes, other._codes, self.device)
        other._codes = None
        return moved

    def reconstruct(self, ids) -> torch.Tensor:
        """The refined reconstruction: raw or SQ rows, or the base's
        reconstruction plus the decoded residual."""
        if self._codes is None:
            raise EmptyInput("index is empty")
        ids = torch.atleast_1d(as_tensor(ids, self._codes.device).to(torch.int64))
        rec = self._decode(self._codes[ids])
        if self.residual:
            rec = rec + self.base.reconstruct(ids)
        return rec

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        if self.kind == "flat":
            return codes.to(torch.float32)
        if self.kind == "sq8":
            return self.sq.dequantize(codes)
        return self.refine_pq.decode(codes)

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus the refined reconstruction of every hit -> ``(ids,
        values, vectors [Q, k, d])``; padded -1 ids give zero rows."""
        return _search_and_reconstruct(self, queries, k, **kw)

    # -- search --------------------------------------------------------------

    def search(self, queries, k: int = 10, *, k_factor: float = 4.0,
               **base_params) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fetch ``ceil(k_factor * k)`` candidates from the base, re-score
        them against the refined reconstructions, return the top-k.
        ``base_params`` go to the base search (e.g. ``nprobe=...``)."""
        q = as_tensor(queries, self.device).to(torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=q.shape[1])
        fn, arrays = self._search_core(int(k), k_factor=k_factor, **base_params)
        return fn(q, *arrays)

    def _search_core(self, k: int, *, k_factor: float = 4.0, **base_params):
        """The refined search as ``(fn, arrays)``: the base fetch, the
        refine-code gather, decode, exact scores and top-k.
        :meth:`search` is one call of it, and
        :class:`vq_tpu_torch.serving.BatchPipeline` loops it over batches."""
        if self._codes is None:
            raise EmptyInput("index is empty — add() vectors first")
        if self._codes.shape[0] != self.base.ntotal:
            raise InvalidData(
                "refine codes out of sync with the base index — add vectors only through "
                "RefineIndex.add")
        k = int(k)
        if float(k_factor) < 1.0:
            raise InvalidParameter("k_factor", "must be >= 1")
        fetch = max(k, int(math.ceil(float(k_factor) * k)))
        base_fn, base_arrays = self.base._search_core(fetch, **base_params)
        arrays = tuple(base_arrays) + (self._codes,)
        rec_fn = None
        if self.residual:
            rec_fn, rec_arrays = self.base._reconstruct_core()
            arrays = arrays + tuple(rec_arrays)
        fn = _build_refine_fn(base_fn, len(base_arrays), self._decode, rec_fn, self.metric, k)
        return fn, arrays

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Write a ``refine_index`` ``.npz`` and its base beside it as
        ``<path>.base.npz`` (bf16 codes as their uint16 bits); returns the
        main path."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "RefineIndex":
        """Load a ``refine_index`` (and its base) saved by either package
        onto ``device``."""
        return load(path, device, expect="refine_index")

    def __repr__(self) -> str:
        return (
            f"RefineIndex(kind={self.kind!r}, base={self.base!r}, "
            f"ntotal={self.ntotal}, metric={self.metric!r})"
        )


def _build_refine_fn(base_fn, nb: int, decode, rec_fn, metric: str, k: int):
    """The re-score: base fetch -> code gather -> decode (+ the base's
    reconstruction when ``rec_fn`` is given) -> exact scores -> top-k,
    with the family's -1 / inf padding."""

    def fn(q, *arrs):
        ids, _ = base_fn(q, *arrs[:nb])  # [Q, F] (-1 pads)
        flat = ids.clamp_min(0).reshape(-1).to(torch.int64)
        rec = decode(arrs[nb][flat])
        if rec_fn is not None:
            rec = rec + rec_fn(flat, *arrs[nb + 1:])
        rec = rec.reshape(*ids.shape, rec.shape[-1])
        exact = torch.where(ids >= 0, _exact_scores(q, rec, metric), float("inf"))
        kk = min(k, exact.shape[1])
        out_d, pos = _smallest(exact, kk)
        out_i = torch.gather(ids, 1, pos)
        out_i = torch.where(torch.isinf(out_d), -1, out_i)
        if kk < k:  # fewer candidates than k: pad to the contract
            out_i = torch.nn.functional.pad(out_i, (0, k - kk), value=-1)
            out_d = torch.nn.functional.pad(out_d, (0, k - kk), value=float("inf"))
        if metric == "dot":
            out_d = -out_d  # descending scores; pads become -inf
        return out_i, out_d

    return fn


def _codec_approx(base, x: torch.Tensor) -> torch.Tensor:
    """The base index's coding of ``x`` without adding it: the residual
    training set of :meth:`RefineIndex.train_pq`."""
    if isinstance(base, IVFPQIndex):
        lists, _ = assign(x, base.coarse)
        c = base.coarse[lists.to(torch.int64)]
        enc = x - c if base.by_residual else x
        rec = base.pq.decode(base.pq.encode(enc))
        return rec + c if base.by_residual else rec
    if isinstance(base, PQIndex):
        return base.pq.decode(base.pq.encode(x))
    if isinstance(base, RQIndex):
        return base.rq.decode(base.rq.encode(x, beam=base.beam))
    if isinstance(base, SQIndex):
        return base.sq.dequantize(base.sq.quantize(x))
    raise InvalidParameter(
        "base", "residual refinement supports PQIndex / SQIndex / RQIndex / IVFPQIndex bases, "
        f"not {type(base).__name__}")


def _refine_state(idx: RefineIndex):
    """``(config, arrays)`` of a :class:`RefineIndex` without its base."""
    if idx._codes is None:
        codes = np.zeros((0, idx.dim), np.float32)
    elif idx.store_dtype == "bfloat16":
        codes = idx._codes.view(torch.int16).cpu().numpy().view(np.uint16)  # npz has no bf16
    else:
        codes = idx._codes.cpu().numpy()
    arrays = {"codes": codes}
    config = {"kind": idx.kind, "metric": idx.metric, "store_dtype": idx.store_dtype}
    if idx.kind == "sq8":
        config["levels"] = idx.levels
        config["sq_fitted"] = idx.sq is not None
        if idx.sq is not None:
            arrays["sq_mins"] = idx.sq.mins.cpu().numpy()
            arrays["sq_maxs"] = idx.sq.maxs.cpu().numpy()
    elif idx.kind == "pq":
        arrays["refine_codebooks"] = idx.refine_pq.codebooks.cpu().numpy()
    return config, arrays


def _refine_from(config, arrays, device, base) -> RefineIndex:
    self = RefineIndex.__new__(RefineIndex)
    self.base = base
    self.metric = config["metric"]
    self.kind = config["kind"]
    self.residual = self.kind == "pq"
    self.store_dtype = config.get("store_dtype")
    self.sq = None
    self.refine_pq = None
    if self.kind == "pq":
        self.refine_pq = ProductQuantizer(
            codebooks=np.asarray(arrays["refine_codebooks"], np.float32),
            distance="squared_euclidean", device=device)
    elif self.kind == "sq8":
        self.levels = int(config.get("levels", 256))
        if config.get("sq_fitted"):
            self.sq = PerDimScalarQuantizer(arrays["sq_mins"], arrays["sq_maxs"], self.levels,
                                            device=device)
    codes = np.asarray(arrays["codes"])
    self._codes = None
    if codes.shape[0]:
        if self.store_dtype == "bfloat16":
            c = torch.from_numpy(codes.view(np.int16).copy()).view(torch.bfloat16)
        else:
            c = torch.from_numpy(codes.copy())
            if self.kind == "flat":
                c = c.to(_STORE_DTYPES[self.store_dtype])
        self._codes = c.to(device)
    if (0 if self._codes is None else self._codes.shape[0]) != base.ntotal:
        raise InvalidData("refine checkpoint out of sync with its base checkpoint")
    return self
