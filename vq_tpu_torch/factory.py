"""Index factory, generic checkpoint loader and ID mapping — the port of
``vq_tpu.factory``.

* :func:`index_factory` — build an index pipeline from a faiss-style spec
  string (``"PCA64,IVF256,PQ8"``), returning a :class:`FactoryIndex`
  shell with the faiss lifecycle: ``train(data)`` -> ``add(x)`` ->
  ``search(q, k)``.
* :func:`load_index` — read any saved index back without knowing its
  type (the ``faiss.read_index`` analog; every index's ``save`` tags its
  checkpoint kind), a wrapper with the base checkpoint it names.
* :class:`IdMapIndex` — user-assigned int64 ids over any positional
  index (``add_with_ids``), the faiss ``IndexIDMap`` analog.

Factory grammar (comma-separated stages, case-sensitive):

=================  ====================================================
stage              meaning
=================  ====================================================
``PCA64``          PCA to 64 dims (``PCAW64`` = whitened)
``L2norm``         row L2 normalization
``RR``             seeded random orthonormal rotation
``OPQ8``           learned OPQ rotation for m=8 subspaces
``ITQ64``          ITQ: PCA to 64 dims and a rotation fitted for sign
                   codes (``ITQ`` keeps the width)
``IDMap``          wrap the final index for user-assigned ids
``Flat``           exact f32 scan (:class:`FlatIndex`)
``SQfp16/SQbf16``  exact scan over half-width rows
``SQ8``/``SQ4``    per-dim scalar codes (:class:`SQIndex`)
``PQ8``/``PQ8x4``  product codes, m x 2^nbits (:class:`PQIndex`)
``RQ4``/``RQ4x8``  additive residual codes (:class:`RQIndex`)
``BFlat``          packed sign bits (:class:`BinaryIndex`)
``LSH32``          faiss ``IndexLSH``: seeded random orthonormal
                   projection to nbits dims (nbits <= d), sign bits,
                   packed Hamming search
``BIVF256``        inverted file over packed sign bits
                   (:class:`IVFBinaryIndex`)
``HNSW32``         navigable graph of degree 32 (:class:`GraphIndex`,
                   the faiss ``IndexHNSWFlat`` role), built by ``train``
``IVF256,<code>``  inverted file with 256 lists over ``Flat``/``SQ8``/
                   ``PQ...``/``PQm+m2``/``RQ...`` coding
                   (:class:`IVFFlatIndex` / :class:`IVFSQIndex` /
                   :class:`IVFPQIndex`, with a residual PQ refine for
                   ``+m2`` / :class:`IVFRQIndex`)
``...,RFlat``      a trailing refine stage (``RFlat``, ``RFlat16``,
                   ``RSQ8``): :class:`RefineIndex` over the index
=================  ====================================================
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, resolve_device
from vq_tpu_torch.utils.serialize import INDEX_KINDS, _from_npz, load, save

__all__ = ["index_factory", "FactoryIndex", "load_index", "IdMapIndex"]


def load_index(path: str, device=None):
    """Load any index saved by either package onto ``device``, dispatching
    on the checkpoint kind (``transformed_index``, ``refine_index`` and
    ``idmap_index`` load their base from the file they name)."""
    kind, _, _ = _from_npz(path)
    if kind not in INDEX_KINDS:
        raise InvalidData(f"not an index checkpoint (kind {kind!r})")
    return load(path, device=device)


class IdMapIndex:
    """User-assigned int64 ids over any positional index (faiss
    ``IndexIDMap`` analog).

    ``add_with_ids`` stores the mapping; ``search`` / ``range_search``
    translate returned positions to user ids (``-1`` padding kept), as an
    int64 tensor on the positions' device; ``remove_ids`` takes user ids.
    The base keeps its sequential renumbering, and the map stays aligned
    by compacting in the same order. The map itself is a host array.
    """

    def __init__(self, base):
        self.base = base
        self._ids = np.zeros((0,), np.int64)
        self._ids_dev = None  # device copy for _translate, made lazily

    @property
    def ntotal(self) -> int:
        return int(self._ids.shape[0])

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def device(self):
        return getattr(self.base, "device", None)

    def _set_ids(self, ids: np.ndarray) -> None:
        self._ids = ids
        self._ids_dev = None

    def add_with_ids(self, vectors, ids) -> None:
        x = as_tensor(vectors, self.device)
        if x.ndim == 1:
            x = x[None, :]
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.shape[0] != x.shape[0]:
            raise InvalidParameter("ids", f"got {ids.shape[0]} ids for {x.shape[0]} vectors")
        if np.intersect1d(ids, self._ids).size or np.unique(ids).size != ids.size:
            raise InvalidParameter("ids", "ids must be unique")
        self.base.add(x)
        self._set_ids(np.concatenate([self._ids, ids]))

    def add(self, vectors) -> None:
        """Sequential auto-ids continuing from the current maximum."""
        x = as_tensor(vectors, self.device)
        n = 1 if x.ndim == 1 else x.shape[0]
        start = int(self._ids.max()) + 1 if self._ids.size else 0
        self.add_with_ids(x, np.arange(start, start + n, dtype=np.int64))

    def _translate(self, pos: torch.Tensor) -> torch.Tensor:
        pos = as_tensor(pos).to(torch.int64)
        if not self._ids.size:
            return torch.full_like(pos, -1)
        if self._ids_dev is None or self._ids_dev.device != pos.device:
            self._ids_dev = torch.from_numpy(self._ids).to(pos.device)
        return torch.where(pos >= 0, self._ids_dev[pos.clamp_min(0)], -1)

    def search(self, queries, k: int = 10, **kw):
        pos, vals = self.base.search(queries, k, **kw)
        return self._translate(pos), vals

    def range_search(self, queries, radius: float, **kw):
        if not hasattr(self.base, "range_search"):
            raise InvalidData(f"{type(self.base).__name__} does not support range_search")
        pos, vals, counts = self.base.range_search(queries, radius, **kw)
        return self._translate(pos), vals, counts

    def remove_ids(self, ids) -> int:
        """Remove by user id; unknown ids are ignored (the faiss contract)."""
        if not self._ids.size:
            raise EmptyInput("index is empty")
        ids = np.atleast_1d(np.asarray(_host(ids), np.int64))
        positions = np.nonzero(np.isin(self._ids, ids))[0]
        if positions.size == 0:
            return 0
        removed = self.base.remove_ids(positions)
        self._set_ids(np.delete(self._ids, positions))
        return removed

    def reconstruct(self, ids) -> torch.Tensor:
        """Reconstruct by user id."""
        if not self._ids.size:
            raise EmptyInput("index is empty")
        ids = np.atleast_1d(np.asarray(_host(ids), np.int64))
        order = np.argsort(self._ids)
        pos = np.searchsorted(self._ids, ids, sorter=order)
        pos = order[np.clip(pos, 0, self._ids.size - 1)]
        if not np.array_equal(self._ids[pos], ids):
            missing = ids[self._ids[pos] != ids]
            raise InvalidParameter("ids", f"unknown ids {missing.tolist()}")
        return self.base.reconstruct(pos)

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search plus decoded hits, with user ids -> ``(ids, values,
        vectors [Q, k, d])``."""
        if not hasattr(self.base, "search_and_reconstruct"):
            raise InvalidData(
                f"{type(self.base).__name__} does not support search_and_reconstruct")
        pos, vals, rec = self.base.search_and_reconstruct(queries, k, **kw)
        return self._translate(pos), vals, rec

    def merge_from(self, other: "IdMapIndex") -> int:
        """Move every vector of ``other`` into this index, keeping its user
        ids (which must not collide with these); ``other`` is left empty."""
        if type(other) is not IdMapIndex:
            raise InvalidParameter("other", "can only merge another IdMapIndex")
        if np.intersect1d(self._ids, other._ids).size:
            raise InvalidData("cannot merge: duplicate user ids")
        moved = self.base.merge_from(other.base)
        self._set_ids(np.concatenate([self._ids, other._ids]))
        other._set_ids(np.zeros((0,), np.int64))
        return moved

    def save(self, path: str) -> str:
        """Write an ``idmap_index`` ``.npz`` (the ids) and its base beside
        it as ``<path>.base.npz``; returns the main path."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "IdMapIndex":
        """Load an ``idmap_index`` (and its base) saved by either package."""
        return load(path, device, expect="idmap_index")

    def __repr__(self) -> str:
        return f"IdMapIndex(ntotal={self.ntotal}, base={self.base!r})"


def _host(ids):
    return ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids


# -- factory -----------------------------------------------------------------

_METRIC_ALIASES = {"l2": "squared_euclidean", "ip": "dot", "inner_product": "dot"}


def _norm_metric(metric: str) -> str:
    m = str(metric).lower()
    return _METRIC_ALIASES.get(m, m)


def _parse_pq(stage: str) -> Tuple[int, int]:
    m_ = re.fullmatch(r"PQ(\d+)(?:x(\d+))?", stage)
    if not m_:
        raise InvalidParameter("spec", f"bad PQ stage {stage!r}")
    m = int(m_.group(1))
    nbits = int(m_.group(2)) if m_.group(2) else 8
    if not 1 <= nbits <= 8:
        raise InvalidParameter("spec", "PQ nbits must be in [1, 8]")
    return m, 2 ** nbits


def _split_pq_refine(code: str) -> Tuple[str, Optional[int]]:
    """Split a ``PQ{m}[x{nbits}][+{m2}]`` stage into the PQ token and the
    optional IVFPQR refinement size (faiss ``IVF...,PQ8+16`` grammar)."""
    if "+" in code:
        head, _, m2 = code.partition("+")
        if not m2.isdigit():
            raise InvalidParameter("spec", f"bad PQ refine stage {code!r}")
        return head, int(m2)
    return code, None


def _parse_rq(stage: str) -> Tuple[int, int]:
    m_ = re.fullmatch(r"RQ(\d+)(?:x(\d+))?", stage)
    if not m_:
        raise InvalidParameter("spec", f"bad RQ stage {stage!r}")
    s = int(m_.group(1))
    nbits = int(m_.group(2)) if m_.group(2) else 8
    if not 1 <= nbits <= 8:
        raise InvalidParameter("spec", "RQ nbits must be in [1, 8]")
    return s, 2 ** nbits


class FactoryIndex:
    """The shell :func:`index_factory` returns: parses the spec up front,
    builds the pipeline at :meth:`train` (the faiss lifecycle) on the
    training data's device, then delegates every index method to it. A
    spec with nothing to fit (``Flat``, ``SQfp16`` / ``SQbf16``,
    ``BFlat``, ``LSH…``, behind ``L2norm`` / ``RR`` only) is built at once
    on ``device`` (the card by default)."""

    def __init__(self, dim: int, spec: str, metric: str, options: Dict[str, Any], device=None):
        self.dim = int(dim)
        self.spec = str(spec)
        self.metric = _norm_metric(metric)
        self.options = dict(options)
        self._device = device
        self._built = None
        stages = [s.strip() for s in self.spec.split(",") if s.strip()]
        if not stages:
            raise InvalidParameter("spec", "empty factory spec")
        self._idmap = stages[0] == "IDMap"
        if self._idmap:
            stages = stages[1:]
        self._transform_specs: List[str] = []
        i = 0
        while i < len(stages) and re.fullmatch(r"PCAW?\d+|L2norm|RR|OPQ\d+|ITQ\d*", stages[i]):
            self._transform_specs.append(stages[i])
            i += 1
        self._index_stages = stages[i:]
        # An optional trailing refine stage (faiss RFlat / Refine(...))
        # wraps the built index in a RefineIndex.
        self._refine_spec: Optional[str] = None
        if len(self._index_stages) > 1 and re.fullmatch(r"RFlat(16)?|RSQ8",
                                                        self._index_stages[-1]):
            self._refine_spec = self._index_stages.pop()
        if not self._index_stages:
            raise InvalidParameter("spec", f"{self.spec!r} has no index stage")
        self._validate_index_stages()
        if not self._needs_training():
            self._built = self._build(None, seed=42, max_iters=10, device=resolve_device(device))

    # -- spec validation ----------------------------------------------------

    def _validate_index_stages(self):
        st = self._index_stages
        head = st[0]
        if head.startswith("IVF"):
            if not re.fullmatch(r"IVF\d+", head):
                raise InvalidParameter("spec", f"bad IVF stage {head!r}")
            if len(st) != 2:
                raise InvalidParameter(
                    "spec", "IVF needs exactly one coding stage (Flat, SQ8, PQ..., or RQ...)")
            code = st[1]
            if code not in ("Flat", "SQ8") and not re.fullmatch(
                    r"PQ\d+(x\d+)?(\+\d+)?|RQ\d+(x\d+)?", code):
                raise InvalidParameter("spec", f"unsupported IVF coding {code!r}")
            if code.startswith("PQ"):
                pq_code, m2 = _split_pq_refine(code)
                _parse_pq(pq_code)
                if m2 is not None and m2 < 1:
                    raise InvalidParameter("spec", f"bad refinement PQ size in {code!r}")
            elif code.startswith("RQ"):
                _parse_rq(code)
            return
        if len(st) != 1:
            raise InvalidParameter("spec", f"unexpected trailing stages {st[1:]!r}")
        if head in ("Flat", "SQfp16", "SQbf16", "SQ8", "SQ4", "BFlat"):
            return
        if re.fullmatch(r"BIVF\d+", head) or re.fullmatch(r"LSH\d+", head):
            return
        if re.fullmatch(r"HNSW\d+", head):
            if self._refine_spec is not None:
                raise InvalidParameter(
                    "spec", "HNSW stores exact rows — a refinement stage adds nothing "
                    "(and the graph is built pre-filled)")
            return
        if head.startswith("PQ"):
            _parse_pq(head)
            return
        if head.startswith("RQ"):
            _parse_rq(head)
            return
        raise InvalidParameter("spec", f"unknown index stage {head!r}")

    def _needs_training(self) -> bool:
        if any(s != "L2norm" and not s.startswith("RR") for s in self._transform_specs):
            return True
        head = self._index_stages[0]
        if re.fullmatch(r"LSH\d+", head):
            return False  # a seeded projection, nothing to fit
        return head not in ("Flat", "SQfp16", "SQbf16", "BFlat")

    @property
    def is_trained(self) -> bool:
        return self._built is not None

    # -- building -----------------------------------------------------------

    def _build_transforms(self, data, seed: int, device):
        from vq_tpu_torch.models.opq import opq_train
        from vq_tpu_torch.transforms import (
            NormalizeTransform,
            PCATransform,
            RotationTransform,
            _itq_fit,
        )

        ts, y, d = [], data, self.dim
        opq_codebooks = None  # (m, k, codebooks), reused by a PQ of that shape
        for s in self._transform_specs:
            if s == "L2norm":
                t = NormalizeTransform(d)
            elif s.startswith("RR"):
                t = RotationTransform.random(d, seed=seed, device=device)
            elif s.startswith("ITQ"):
                # faiss ITQMatrix: PCA and a rotation fitted for sign codes;
                # the projection is already applied to y.
                d_out = int(s[3:]) if len(s) > 3 else d
                chain, y = _itq_fit(y, d_out, iters=50, seed=seed)
                for t_ in chain[:-1]:
                    ts.append(t_)
                    d = t_.d_out
                t = chain[-1]
            elif s.startswith("PCA"):
                whiten = s.startswith("PCAW")
                t = PCATransform(d, int(s[4 if whiten else 3:]), whiten=whiten).fit(y)
            else:  # OPQ{m}
                m = int(s[3:])
                k = 256
                if self._index_stages[-1].startswith("PQ"):
                    _, k = _parse_pq(self._index_stages[-1])
                rotation, cbs = opq_train(y, m, k, seed=seed)
                t = RotationTransform(rotation)
                opq_codebooks = (m, k, cbs)
            if y is not None:
                y = t.apply(y)
            ts.append(t)
            d = t.d_out
        return ts, y, d, opq_codebooks

    def _build(self, data, *, seed: int, max_iters: int, device):
        from vq_tpu_torch.search import BinaryIndex, FlatIndex, PQIndex, RQIndex, SQIndex
        from vq_tpu_torch.transforms import RotationTransform, TransformedIndex

        opts = self.options
        keep_corpus = bool(opts.get("keep_corpus", False))
        ts, y, d, opq_cbs = self._build_transforms(data, seed, device)
        metric = self.metric
        st = self._index_stages
        head = st[0]
        if head.startswith("IVF"):
            nlist = int(head[3:])
            ivf_metric = {"squared_euclidean": "l2", "dot": "dot"}.get(metric)
            if ivf_metric is None:
                raise InvalidParameter(
                    "metric", f"IVF indexes support 'l2' and 'dot', not {metric!r}")
            mls = opts.get("max_list_size")
            code = st[1]
            if code == "Flat":
                from vq_tpu_torch.ivf_flat import IVFFlatIndex

                base = IVFFlatIndex.train(y, nlist, max_iters=max_iters, seed=seed,
                                          metric=ivf_metric, max_list_size=mls,
                                          store_dtype=opts.get("store_dtype", "float32"))
            elif code == "SQ8":
                from vq_tpu_torch.ivf_flat import IVFSQIndex

                base = IVFSQIndex.train(y, nlist, max_iters=max_iters, seed=seed,
                                        metric=ivf_metric, max_list_size=mls)
            elif code.startswith("RQ"):
                from vq_tpu_torch.ivf_flat import IVFRQIndex

                s_, kk = _parse_rq(code)
                base = IVFRQIndex.train(y, nlist, s_, kk, max_iters=max_iters, seed=seed,
                                        metric=ivf_metric, max_list_size=mls,
                                        beam=int(opts.get("beam", 1)))
            else:
                from vq_tpu_torch.ivf import IVFPQIndex

                pq_code, m2 = _split_pq_refine(code)
                m, k = _parse_pq(pq_code)
                base = IVFPQIndex.train(y, nlist, m, k, max_iters=max_iters, seed=seed,
                                        metric=ivf_metric, keep_corpus=keep_corpus)
                if m2 is not None:  # IVFPQR (faiss "IVF...,PQm+m2"): a residual refine PQ
                    from vq_tpu_torch.refine import RefineIndex

                    base = RefineIndex.train_pq(base, y, m2, max_iters=max_iters, seed=seed + 7)
        elif head == "Flat":
            base = FlatIndex(d, metric=metric, device=device)
        elif head in ("SQfp16", "SQbf16"):
            base = FlatIndex(d, metric=metric, device=device,
                             storage="float16" if head == "SQfp16" else "bfloat16")
        elif head == "BFlat":
            base = BinaryIndex(d, keep_corpus=keep_corpus, device=device)
        elif head.startswith("LSH"):
            # faiss IndexLSH: a seeded random orthonormal projection to
            # nbits dims, sign bits, packed Hamming search.
            nbits = int(head[3:])
            if nbits > d:
                raise InvalidParameter("spec", f"LSH{nbits} exceeds input dim {d}")
            proj = RotationTransform.random(d, seed=seed, d_out=nbits, device=device)
            base = TransformedIndex([proj], BinaryIndex(nbits, keep_corpus=keep_corpus,
                                                        device=device))
        elif head.startswith("HNSW"):
            # GraphIndex in the IndexHNSWFlat role. Unlike faiss, train(data)
            # builds the graph over (and stores) the training rows, since
            # the build needs a global candidate set; add() then inserts.
            from vq_tpu_torch.graph import GraphIndex

            if metric != "squared_euclidean":
                raise InvalidParameter(
                    "metric", "HNSW (GraphIndex) navigates in L2; L2-normalize via an "
                    "'L2norm' prefix for cosine")
            base = GraphIndex.build(y, degree=int(head[4:]), seed=seed,
                                    store_dtype=opts.get("store_dtype", "float32"),
                                    alpha=float(opts.get("alpha", 1.2)))
        elif head.startswith("BIVF"):
            from vq_tpu_torch.ivf_binary import IVFBinaryIndex

            if metric != "squared_euclidean":
                raise InvalidParameter(
                    "metric", "BIVF searches Hamming space (coarse probe is L2); "
                    f"metric {metric!r} is not supported")
            base = IVFBinaryIndex.train(y, int(head[4:]), max_iters=max_iters, seed=seed,
                                        max_list_size=opts.get("max_list_size"),
                                        keep_corpus=keep_corpus)
        elif head in ("SQ8", "SQ4"):
            from vq_tpu_torch.models.sq import PerDimScalarQuantizer

            base = SQIndex(PerDimScalarQuantizer.from_data(y, 256 if head == "SQ8" else 16),
                           metric=metric, keep_corpus=keep_corpus)
        elif head.startswith("PQ"):
            from vq_tpu_torch.models.pq import ProductQuantizer

            m, k = _parse_pq(head)
            if metric == "dot":
                raise InvalidParameter(
                    "metric", "flat PQ is L2-family only; use IVF...,PQ... with metric='dot' "
                    "or AnisotropicProductQuantizer + mips_adc_search for MIPS")
            if opq_cbs is not None and opq_cbs[:2] == (m, k):
                # OPQ trained codebooks of this shape on the rotated data.
                pq = ProductQuantizer(codebooks=opq_cbs[2], distance=metric)
            else:
                pq = ProductQuantizer(y, m, k, max_iters=max_iters, distance=metric, seed=seed)
            base = PQIndex(pq, keep_corpus=keep_corpus)
        else:  # RQ
            from vq_tpu_torch.models.rq import ResidualQuantizer, rq_train

            s_, k = _parse_rq(head)
            rq = ResidualQuantizer(codebooks=rq_train(y, s_, k, max_iters=max_iters, seed=seed))
            base = RQIndex(rq, metric=metric, keep_corpus=keep_corpus)
        if self._refine_spec is not None:
            from vq_tpu_torch.refine import RefineIndex

            if self._refine_spec == "RFlat":
                base = RefineIndex(base, "flat")
            elif self._refine_spec == "RFlat16":
                base = RefineIndex(base, "flat", store_dtype="bfloat16")
            else:  # RSQ8
                base = RefineIndex(base, "sq8", sq_train_data=y)
        built = TransformedIndex(ts, base) if ts else base
        return IdMapIndex(built) if self._idmap else built

    def train(self, data, *, seed: int = 42, max_iters: int = 10) -> "FactoryIndex":
        """Fit the transforms and quantizers on ``data`` (on its device, or
        the factory's ``device`` for non-tensor input) and build the
        pipeline. Returns self (chainable)."""
        x = as_tensor(data, self._device).to(torch.float32)
        if x.ndim != 2 or x.shape[0] == 0:
            raise InvalidParameter("data", "expected a non-empty [n, d] array")
        if x.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[1])
        self._built = self._build(x, seed=seed, max_iters=max_iters, device=x.device)
        return self

    # -- delegation -----------------------------------------------------------

    def _require(self):
        if self._built is None:
            raise InvalidData(f"index {self.spec!r} is untrained — call train(data) first")
        return self._built

    @property
    def index(self):
        """The concrete built pipeline (after training)."""
        return self._require()

    @property
    def ntotal(self) -> int:
        return 0 if self._built is None else self._built.ntotal

    def add(self, vectors) -> None:
        self._require().add(vectors)

    def add_with_ids(self, vectors, ids) -> None:
        built = self._require()
        if not isinstance(built, IdMapIndex):
            raise InvalidData("add_with_ids needs an 'IDMap,...' factory spec")
        built.add_with_ids(vectors, ids)

    def search(self, queries, k: int = 10, **kw):
        return self._require().search(queries, k, **kw)

    def _search_core(self, k: int, **kw):
        built = self._require()
        if not hasattr(built, "_search_core"):
            raise InvalidData(f"{type(built).__name__} does not support pipelined serving")
        return built._search_core(int(k), **kw)

    def range_search(self, queries, radius: float, **kw):
        built = self._require()
        if not hasattr(built, "range_search"):
            raise InvalidData(f"{type(built).__name__} does not support range_search")
        return built.range_search(queries, radius, **kw)

    def remove_ids(self, ids) -> int:
        return self._require().remove_ids(ids)

    def reconstruct(self, ids):
        return self._require().reconstruct(ids)

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        built = self._require()
        if not hasattr(built, "search_and_reconstruct"):
            raise InvalidData(
                f"{type(built).__name__} does not support search_and_reconstruct")
        return built.search_and_reconstruct(queries, k, **kw)

    def merge_from(self, other) -> int:
        """Merge another trained index built from the same spec (or a bare
        compatible index) into this one."""
        peer = other._require() if isinstance(other, FactoryIndex) else other
        return self._require().merge_from(peer)

    def save(self, path: str) -> str:
        return self._require().save(path)

    def __repr__(self) -> str:
        state = "trained" if self.is_trained else "untrained"
        return f"FactoryIndex({self.spec!r}, dim={self.dim}, metric={self.metric!r}, {state})"


def index_factory(dim: int, spec: str, metric: str = "squared_euclidean", *, device=None,
                  **options) -> FactoryIndex:
    """Build an index pipeline from a faiss-style spec string.

    ``metric`` takes the port's metric names plus the aliases ``"l2"`` and
    ``"ip"`` / ``"inner_product"``. ``options`` go to the terminal index
    (``keep_corpus``, ``max_list_size``, ``store_dtype``, ``alpha``,
    ``beam``). ``device`` is where non-tensor training data lands, and
    where a spec with nothing to fit is built.

    >>> import numpy as np
    >>> f = index_factory(8, "IVF4,PQ2", device="cpu")
    >>> f.is_trained
    False
    >>> x = np.random.default_rng(0).random((256, 8), dtype=np.float32)
    >>> _ = f.train(x)  # returns self for chaining
    >>> f.add(x)
    >>> f.ntotal, f.is_trained
    (256, True)
    >>> ids, dist = f.search(x[:2], k=3, nprobe=2)
    >>> tuple(ids.shape)
    (2, 3)
    """
    return FactoryIndex(dim, spec, metric, options, device=device)
