"""Trained state across packages: a model as ``(kind, config, arrays)``.

This is the layout of the single-file ``.npz`` checkpoints that both
packages write (``vq_tpu.utils.serialize``): ``kind`` names the class,
``config`` holds its settings as JSON values and ``arrays`` its numpy
arrays. The JAX package's parameters, taken as numpy arrays, become the
port's objects through :func:`from_state`, and :func:`state_of` gives the
port's state back in the same form, so a model moves either way without
JAX being imported here.

Kinds ported so far (config; arrays):

* ``"pq"`` — :class:`ProductQuantizer` (``distance``; ``codebooks``);
* ``"pq_aniso"`` — :class:`AnisotropicProductQuantizer` (``eta``;
  ``codebooks``);
* ``"opq"`` — :class:`OPQQuantizer` (none; ``rotation``, ``codebooks``);
* ``"sq"`` — :class:`ScalarQuantizer` (``min``, ``max``, ``levels``; none);
* ``"sq_perdim"`` — :class:`PerDimScalarQuantizer` (``levels``; ``mins``,
  ``maxs``);
* ``"pq_index"`` — :class:`PQIndex` (``distance``, ``keep_corpus``,
  ``pack_bits``; ``codebooks``, ``codes`` and, when kept, ``corpus``);
* ``"ivfpq_index"`` — :class:`IVFPQIndex` (``by_residual``,
  ``keep_corpus``, ``max_list_size``, ``metric`` and, for an
  anisotropic PQ, ``pq_eta``; ``coarse``,
  ``codebooks``, ``flat_codes`` and ``flat_lists`` in id order, and, when
  kept, ``corpus``);
* ``"ivfflat_index"`` — :class:`IVFFlatIndex` (``metric``,
  ``store_dtype``, ``max_list_size``; ``coarse``, ``rows`` and ``lists``
  in id order, bf16 rows as their uint16 bits, since npz has no bf16);
* ``"ivfsq_index"`` — :class:`IVFSQIndex` (``metric``, ``by_residual``,
  ``levels``, ``max_list_size``; ``coarse``, ``mins``, ``maxs``, ``codes``,
  ``sqn`` and ``lists`` in id order);
* ``"bq"`` — :class:`BinaryQuantizer` (``threshold``, ``low``, ``high``;
  none);
* ``"tsvq"`` — :class:`TSVQ` (``distance``, ``depth``; ``centroids``,
  ``left``, ``right``);
* ``"rq"`` — :class:`ResidualQuantizer` (none; ``codebooks``);
* ``"rq_index"`` — :class:`RQIndex` (``metric``, ``keep_corpus``,
  ``beam``; ``codebooks``, ``codes``, ``row_sqn`` and, when kept,
  ``corpus``);
* ``"flat_index"`` — :class:`FlatIndex` (``dim``, ``metric``,
  ``storage``; ``rows``, bf16 rows as f32, and ``row_sqn``);
* ``"sq_index"`` — :class:`SQIndex` (``levels``, ``metric``,
  ``keep_corpus``; ``mins``, ``maxs``, ``codes`` as stored, packed when
  sub-byte, ``row_sqn`` and, when kept, ``corpus``);
* ``"binary_index"`` — :class:`BinaryIndex` (``dim``, ``threshold``,
  ``keep_corpus``; ``packed`` uint32 words and, when kept, ``corpus``);
* ``"ivfrq_index"`` — :class:`IVFRQIndex` (``metric``, ``by_residual``,
  ``beam``, ``max_list_size``; ``coarse``, ``codebooks``, ``codes``,
  ``sqn``, ``cross`` and ``lists`` in id order);
* ``"ivfbinary_index"`` — :class:`IVFBinaryIndex` (``threshold``,
  ``max_list_size``, ``keep_corpus``, ``dim``; ``coarse``, ``packed``
  uint32 words, ``lists`` and ``corpus`` in id order, ``corpus`` with no
  rows unless kept);
* ``"kmeans_harness"`` — :class:`Kmeans` (``d``, ``k``, ``niter``,
  ``nredo``, ``seed``, ``spherical``, ``init``,
  ``max_points_per_centroid``, ``obj``, ``all_objs``; ``centroids`` when
  trained);
* the vector transforms, as a ``transformed_index`` holds them:
  ``"center"`` — :class:`CenteringTransform` (``dim``; ``mean``),
  ``"l2norm"`` — :class:`NormalizeTransform` (``dim``; none),
  ``"rotation"`` — :class:`RotationTransform` (none; ``matrix``) and
  ``"pca"`` — :class:`PCATransform` (``d_in``, ``d_out``, ``whiten``,
  ``eps``; ``mean``, ``components``, ``eigvals``);
* the wrappers, whose base index is a checkpoint of its own (named by
  ``base_file`` in the saved config, passed to :func:`from_state` as
  ``base``): ``"transformed_index"`` — :class:`TransformedIndex`
  (``transforms``, a list of ``{"kind", "config"}``; transform ``i``'s
  arrays as ``t<i>_<name>``), ``"refine_index"`` — :class:`RefineIndex`
  (``kind``, ``metric``, ``store_dtype`` and, for ``sq8``, ``levels``
  and ``sq_fitted``; ``codes``, bf16 as their uint16 bits, ``sq_mins``
  / ``sq_maxs`` or ``refine_codebooks``) and ``"idmap_index"`` —
  :class:`IdMapIndex` (none; ``ids`` int64).

A JAX index carries across as, e.g., ``from_state("ivfflat_index",
config, {"coarse": ..., "rows": ..., "lists": ...})``: the port's index
holds the same lists and rows in the same pool layout, so it computes
the same search.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, resolve_device

State = Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(t)


def _optional(t, empty: np.ndarray) -> np.ndarray:
    return empty if t is None else _np(t)


def _lists(idx) -> np.ndarray:
    return np.zeros((0,), np.int32) if idx._flat_lists is None else _np(idx._flat_lists)


def _pool_flat(idx, name: str, empty: np.ndarray) -> np.ndarray:
    """Payload ``name`` of an IVF index in id order (``empty`` if none)."""
    if idx._pool is None or idx._pool.n_rows == 0:
        return empty
    return idx._pool.to_flat([name])[name]


def state_of(obj) -> State:
    """``(kind, config, arrays)`` of a port object, arrays as numpy (a
    wrapper's without its base)."""
    from vq_tpu_torch.clustering import Kmeans, _kmeans_state
    from vq_tpu_torch.factory import IdMapIndex
    from vq_tpu_torch.refine import RefineIndex, _refine_state
    from vq_tpu_torch.transforms import TransformedIndex, VectorTransform, _transformed_state
    from vq_tpu_torch.ivf import IVFPQIndex
    from vq_tpu_torch.ivf_binary import IVFBinaryIndex
    from vq_tpu_torch.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex
    from vq_tpu_torch.models.bq import BinaryQuantizer
    from vq_tpu_torch.models.opq import OPQQuantizer
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.models.pq_anisotropic import AnisotropicProductQuantizer
    from vq_tpu_torch.models.rq import ResidualQuantizer
    from vq_tpu_torch.models.sq import PerDimScalarQuantizer, ScalarQuantizer
    from vq_tpu_torch.models.tsvq import TSVQ
    from vq_tpu_torch.search import BinaryIndex, FlatIndex, PQIndex, RQIndex, SQIndex

    if isinstance(obj, Kmeans):
        return ("kmeans_harness",) + _kmeans_state(obj)
    if isinstance(obj, VectorTransform):
        return obj._state()
    if isinstance(obj, TransformedIndex):
        return ("transformed_index",) + _transformed_state(obj)
    if isinstance(obj, RefineIndex):
        return ("refine_index",) + _refine_state(obj)
    if isinstance(obj, IdMapIndex):
        return "idmap_index", {}, {"ids": np.asarray(obj._ids, np.int64)}
    if isinstance(obj, FlatIndex):
        return "flat_index", {"dim": obj.dim, "metric": obj.metric, "storage": obj.storage}, {
            "rows": _np(obj._rows) if obj._rows is not None else np.zeros((0, obj.dim), np.float32),
            "row_sqn": _optional(obj._row_sqn, np.zeros((0,), np.float32)),
        }
    if isinstance(obj, SQIndex):
        arrays = {"mins": _np(obj.sq.mins), "maxs": _np(obj.sq.maxs),
                  "codes": _optional(obj._codes, np.zeros((0, obj.dim), np.uint8)),
                  "row_sqn": _optional(obj._row_sqn, np.zeros((0,), np.float32))}
        if obj.keep_corpus and obj._corpus is not None:
            arrays["corpus"] = _np(obj._corpus)
        config = {"levels": obj.sq.levels, "metric": obj.metric,
                  "keep_corpus": bool(obj.keep_corpus)}
        return "sq_index", config, arrays
    if isinstance(obj, BinaryIndex):
        arrays = {"packed": _optional(obj._packed, np.zeros((0, (obj.dim + 31) // 32), np.uint32))}
        if obj.keep_corpus and obj._corpus is not None:
            arrays["corpus"] = _np(obj._corpus)
        config = {"dim": obj.dim, "threshold": obj.bq.threshold,
                  "keep_corpus": bool(obj.keep_corpus)}
        return "binary_index", config, arrays
    if isinstance(obj, BinaryQuantizer):
        return "bq", {"threshold": obj.threshold, "low": obj.low, "high": obj.high}, {}
    if isinstance(obj, TSVQ):
        t = obj.tree
        return "tsvq", {"distance": obj.distance_metric, "depth": t.depth}, {
            "centroids": _np(t.centroids), "left": _np(t.left), "right": _np(t.right),
        }
    if isinstance(obj, IVFRQIndex):
        s = obj.rq.num_stages
        config = {"metric": obj.metric, "by_residual": obj.by_residual, "beam": obj.beam,
                  "max_list_size": obj.max_list_size}
        return "ivfrq_index", config, {
            "coarse": _np(obj.coarse), "codebooks": _np(obj.rq.codebooks),
            "codes": _np(_pool_flat(obj, "codes", np.zeros((0, s), np.uint8))),
            "sqn": _np(_pool_flat(obj, "sqn", np.zeros((0,), np.float32))),
            "cross": _np(_pool_flat(obj, "cross", np.zeros((0,), np.float32))),
            "lists": _lists(obj),
        }
    if isinstance(obj, RQIndex):
        arrays = {
            "codebooks": _np(obj.rq.codebooks),
            "codes": (_np(obj._codes) if obj._codes is not None
                      else np.zeros((0, obj.rq.num_stages), np.uint8)),
            "row_sqn": (_np(obj._row_sqn) if obj._row_sqn is not None
                        else np.zeros((0,), np.float32)),
        }
        if obj.keep_corpus and obj._corpus is not None:
            arrays["corpus"] = _np(obj._corpus)
        config = {"metric": obj.metric, "keep_corpus": bool(obj.keep_corpus), "beam": obj.beam}
        return "rq_index", config, arrays
    if isinstance(obj, ResidualQuantizer):
        return "rq", {}, {"codebooks": _np(obj.codebooks)}
    if isinstance(obj, IVFBinaryIndex):
        config = {"threshold": obj.bq.threshold, "max_list_size": obj.max_list_size,
                  "keep_corpus": obj.keep_corpus, "dim": obj.dim}
        no_corpus = np.zeros((0, obj.dim), np.float32)
        return "ivfbinary_index", config, {
            "coarse": _np(obj.coarse),
            "packed": _np(_pool_flat(obj, "codes", np.zeros((0, obj.code_words), np.uint32))),
            "lists": _lists(obj),
            "corpus": _np(_pool_flat(obj, "corpus", no_corpus)) if obj.keep_corpus else no_corpus,
        }
    if isinstance(obj, IVFFlatIndex):
        rows = _pool_flat(obj, "rows", np.zeros((0, obj.dim), np.float32))
        if obj.store_dtype == "bfloat16" and rows.shape[0]:
            rows = rows.view(torch.int16).cpu().numpy().view(np.uint16)  # the raw bits
        config = {"metric": obj.metric, "store_dtype": obj.store_dtype,
                  "max_list_size": obj.max_list_size}
        return "ivfflat_index", config, {
            "coarse": _np(obj.coarse), "rows": _np(rows), "lists": _lists(obj),
        }
    if isinstance(obj, IVFSQIndex):
        config = {"metric": obj.metric, "by_residual": obj.by_residual,
                  "levels": obj.sq.levels, "max_list_size": obj.max_list_size}
        return "ivfsq_index", config, {
            "coarse": _np(obj.coarse), "mins": _np(obj.sq.mins), "maxs": _np(obj.sq.maxs),
            "codes": _np(_pool_flat(obj, "codes", np.zeros((0, obj.dim), np.uint8))),
            "sqn": _np(_pool_flat(obj, "sqn", np.zeros((0,), np.float32))),
            "lists": _lists(obj),
        }
    if isinstance(obj, IVFPQIndex):
        arrays = {
            "coarse": _np(obj.coarse),
            "codebooks": _np(obj.pq.codebooks),
            "flat_codes": _np(_pool_flat(
                obj, "codes", np.zeros((0, obj.pq.num_subspaces), np.int32))),
            "flat_lists": _lists(obj),
        }
        if obj.keep_corpus and obj._corpus is not None:
            arrays["corpus"] = _np(obj._corpus)
        config = {
            "by_residual": obj.by_residual,
            "keep_corpus": obj.keep_corpus,
            "max_list_size": obj.max_list_size,
            "metric": obj.metric,
        }
        if isinstance(obj.pq, AnisotropicProductQuantizer):
            config["pq_eta"] = float(obj.pq.eta)  # the anisotropic PQ round-trips
        return "ivfpq_index", config, arrays
    if isinstance(obj, PQIndex):
        width = obj.code_bytes_per_vector if obj.pack_bits < 8 else obj.pq.num_subspaces
        arrays = {
            "codebooks": _np(obj.pq.codebooks),
            "codes": (
                _np(obj._codes) if obj._codes is not None
                else np.zeros((0, width), np.uint8)
            ),
        }
        if obj.keep_corpus and obj._corpus is not None:
            arrays["corpus"] = _np(obj._corpus)
        config = {
            "distance": obj.pq.distance_metric,
            "keep_corpus": bool(obj.keep_corpus),
            "pack_bits": int(obj.pack_bits),
        }
        return "pq_index", config, arrays
    if isinstance(obj, OPQQuantizer):
        return "opq", {}, {"rotation": _np(obj.rotation), "codebooks": _np(obj.codebooks)}
    if isinstance(obj, AnisotropicProductQuantizer):  # before its base class, ProductQuantizer
        return "pq_aniso", {"eta": obj.eta}, {"codebooks": _np(obj.codebooks)}
    if isinstance(obj, ProductQuantizer):
        return "pq", {"distance": obj.distance_metric}, {"codebooks": _np(obj.codebooks)}
    if isinstance(obj, PerDimScalarQuantizer):
        return "sq_perdim", {"levels": obj.levels}, {"mins": _np(obj.mins), "maxs": _np(obj.maxs)}
    if isinstance(obj, ScalarQuantizer):
        return "sq", {"min": obj.min, "max": obj.max, "levels": obj.levels}, {}
    raise InvalidParameter(
        "quantizer", f"don't know how to serialize {type(obj).__name__}"
    )


def _ivfflat_from(config, arrays, device):
    from vq_tpu_torch.ivf_flat import IVFFlatIndex

    idx = IVFFlatIndex(
        np.asarray(arrays["coarse"], np.float32), metric=config["metric"],
        store_dtype=config["store_dtype"], max_list_size=config.get("max_list_size"),
        device=device,
    )
    rows = np.asarray(arrays["rows"])
    if rows.shape[0]:
        if config["store_dtype"] == "bfloat16":
            rows_t = torch.from_numpy(rows.view(np.int16).copy()).view(torch.bfloat16)
        else:
            rows_t = torch.as_tensor(rows)
        lists = as_tensor(np.asarray(arrays["lists"], np.int32), device)
        idx._append_rows(lists, rows_t.to(device))
    return idx


def _ivfsq_from(config, arrays, device):
    from vq_tpu_torch.ivf_flat import IVFSQIndex
    from vq_tpu_torch.models.sq import PerDimScalarQuantizer

    sq = PerDimScalarQuantizer(arrays["mins"], arrays["maxs"], config["levels"], device=device)
    idx = IVFSQIndex(
        np.asarray(arrays["coarse"], np.float32), sq, metric=config["metric"],
        by_residual=bool(config["by_residual"]), max_list_size=config.get("max_list_size"),
        device=device,
    )
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        lists = as_tensor(np.asarray(arrays["lists"], np.int32), device)
        idx._append(lists, {"codes": as_tensor(codes, device),
                            "sqn": as_tensor(np.asarray(arrays["sqn"]), device)})
    return idx


def _rq_from(arrays, device):
    from vq_tpu_torch.models.rq import ResidualQuantizer

    return ResidualQuantizer(codebooks=np.asarray(arrays["codebooks"], np.float32),
                             device=device)


def _rq_index_from(config, arrays, device):
    from vq_tpu_torch.search import RQIndex

    idx = RQIndex(_rq_from(arrays, device), metric=config["metric"],
                  keep_corpus=bool(config["keep_corpus"]), beam=config.get("beam", 1))
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        idx._codes = as_tensor(codes, device)
        idx._row_sqn = as_tensor(np.asarray(arrays["row_sqn"]), device)
    if "corpus" in arrays:
        idx._corpus = as_tensor(np.asarray(arrays["corpus"]), device)
    return idx


def _ivfrq_from(config, arrays, device):
    from vq_tpu_torch.ivf_flat import IVFRQIndex

    idx = IVFRQIndex(
        np.asarray(arrays["coarse"], np.float32), _rq_from(arrays, device),
        metric=config["metric"], by_residual=bool(config["by_residual"]),
        beam=config.get("beam", 1), max_list_size=config.get("max_list_size"), device=device,
    )
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        lists = as_tensor(np.asarray(arrays["lists"], np.int32), device)
        idx._append(lists, {name: as_tensor(np.asarray(arrays[name]), device)
                            for name in ("codes", "sqn", "cross")})
    return idx


def _ivfbinary_from(config, arrays, device):
    from vq_tpu_torch.ivf_binary import IVFBinaryIndex

    idx = IVFBinaryIndex(
        np.asarray(arrays["coarse"], np.float32), threshold=config["threshold"],
        max_list_size=config.get("max_list_size"),
        keep_corpus=bool(config.get("keep_corpus", False)), device=device,
    )
    packed = np.asarray(arrays["packed"])
    if packed.shape[0]:
        payloads = {"codes": torch.from_numpy(packed.astype(np.uint32)).to(device)}
        if idx.keep_corpus:
            corpus = np.asarray(arrays.get("corpus", np.zeros((0, idx.dim), np.float32)))
            if corpus.shape[0] != packed.shape[0]:
                # The JAX package's loader fails here with KeyError('corpus') (R4).
                raise InvalidData(
                    f"ivfbinary_index keeps a corpus but holds {corpus.shape[0]} corpus rows "
                    f"for {packed.shape[0]} packed rows"
                )
            payloads["corpus"] = as_tensor(corpus.astype(np.float32), device)
        idx._append(as_tensor(np.asarray(arrays["lists"], np.int32), device), payloads)
    return idx


def _flat_index_from(config, arrays, device):
    from vq_tpu_torch.search import _STORAGE, FlatIndex

    idx = FlatIndex(config["dim"], metric=config["metric"], storage=config["storage"],
                    device=device)
    rows = np.asarray(arrays["rows"])
    if rows.shape[0]:
        idx._rows = torch.as_tensor(rows).to(device=device, dtype=_STORAGE[config["storage"]])
        idx._row_sqn = as_tensor(np.asarray(arrays["row_sqn"]), device)
    return idx


def _sq_index_from(config, arrays, device):
    from vq_tpu_torch.search import SQIndex

    idx = SQIndex(_sq_perdim_from(config, arrays, device), metric=config["metric"],
                  keep_corpus=bool(config["keep_corpus"]))
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        idx._codes = as_tensor(codes, device)
        idx._row_sqn = as_tensor(np.asarray(arrays["row_sqn"]), device)
    if "corpus" in arrays:
        idx._corpus = as_tensor(np.asarray(arrays["corpus"]), device)
    return idx


def _binary_index_from(config, arrays, device):
    from vq_tpu_torch.search import BinaryIndex

    idx = BinaryIndex(config["dim"], threshold=config["threshold"],
                      keep_corpus=bool(config["keep_corpus"]), device=device)
    packed = np.asarray(arrays["packed"])
    if packed.shape[0]:
        idx._packed = as_tensor(packed.astype(np.uint32), device)
    if "corpus" in arrays:
        idx._corpus = as_tensor(np.asarray(arrays["corpus"], np.float32), device)
    return idx


def _ivfpq_from(config, arrays, device):
    from vq_tpu_torch.ivf import IVFPQIndex

    if config.get("pq_eta") is not None:
        pq = _pq_aniso_from({"eta": config["pq_eta"]}, arrays, device)
    else:
        pq = _pq_from(arrays, "squared_euclidean", device)
    idx = IVFPQIndex(
        np.asarray(arrays["coarse"], np.float32), pq,
        by_residual=bool(config["by_residual"]),
        keep_corpus=bool(config["keep_corpus"]),
        # Checkpoints of early rounds carry neither of these two.
        max_list_size=config.get("max_list_size"),
        metric=config.get("metric", "l2"),
    )
    codes = np.asarray(arrays["flat_codes"])
    if codes.shape[0]:
        lists = as_tensor(np.asarray(arrays["flat_lists"], np.int32), device)
        idx._pool_append(lists, as_tensor(codes, device))
    if "corpus" in arrays:
        idx._corpus = as_tensor(np.asarray(arrays["corpus"]), device)
    return idx


def _pq_index_from(config, arrays, device):
    from vq_tpu_torch.search import PQIndex

    # Checkpoints written before sub-byte packing carry no pack_bits.
    pack_bits = int(config.get("pack_bits", 8))
    idx = PQIndex(_pq_from(arrays, config["distance"], device),
                  keep_corpus=bool(config["keep_corpus"]), packed=pack_bits < 8)
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        idx._codes = as_tensor(codes, device)
    if "corpus" in arrays:
        idx._corpus = as_tensor(np.asarray(arrays["corpus"]), device)
    return idx


def _pq_from(arrays, distance, device):
    from vq_tpu_torch.models.pq import ProductQuantizer

    return ProductQuantizer(codebooks=np.asarray(arrays["codebooks"], np.float32),
                            distance=distance, device=device)


def _pq_aniso_from(config, arrays, device):
    from vq_tpu_torch.models.pq_anisotropic import AnisotropicProductQuantizer

    return AnisotropicProductQuantizer(codebooks=np.asarray(arrays["codebooks"], np.float32),
                                       eta=config["eta"], device=device)


def _opq_from(config, arrays, device):
    from vq_tpu_torch.models.opq import OPQQuantizer

    return OPQQuantizer(rotation=np.asarray(arrays["rotation"], np.float32),
                        codebooks=np.asarray(arrays["codebooks"], np.float32), device=device)


def _sq_from(config, arrays, device):
    from vq_tpu_torch.models.sq import ScalarQuantizer

    return ScalarQuantizer(min=config["min"], max=config["max"], levels=config["levels"])


def _sq_perdim_from(config, arrays, device):
    from vq_tpu_torch.models.sq import PerDimScalarQuantizer

    return PerDimScalarQuantizer(arrays["mins"], arrays["maxs"], config["levels"], device=device)


def _bq_from(config, arrays, device):
    from vq_tpu_torch.models.bq import BinaryQuantizer

    return BinaryQuantizer(config["threshold"], config["low"], config["high"])


def _tsvq_from(config, arrays, device):
    from vq_tpu_torch.models.tsvq import TSVQ, TSVQTree

    tree = TSVQTree(np.asarray(arrays["centroids"], np.float32), np.asarray(arrays["left"]),
                    np.asarray(arrays["right"]), config["depth"], device=device)
    return TSVQ(distance=config["distance"], tree=tree)


def _kmeans_from(config, arrays, device):
    from vq_tpu_torch.clustering import _kmeans_from

    return _kmeans_from(config, arrays, device)


def _transform_from(kind):
    def build(config, arrays, device):
        from vq_tpu_torch.transforms import VectorTransform

        return VectorTransform._from_state(kind, config, arrays, device)

    return build


def _transformed_from(config, arrays, device, base):
    from vq_tpu_torch.transforms import _transformed_from

    return _transformed_from(config, arrays, device, base)


def _refine_from(config, arrays, device, base):
    from vq_tpu_torch.refine import _refine_from

    return _refine_from(config, arrays, device, base)


def _idmap_from(config, arrays, device, base):
    from vq_tpu_torch.factory import IdMapIndex

    idx = IdMapIndex(base)
    idx._set_ids(np.asarray(arrays["ids"], np.int64))
    return idx


# Kinds whose base index is a checkpoint of its own.
_WRAPPERS = {
    "transformed_index": _transformed_from,
    "refine_index": _refine_from,
    "idmap_index": _idmap_from,
}

_FROM_STATE = {
    "kmeans_harness": _kmeans_from,
    **{kind: _transform_from(kind) for kind in ("center", "l2norm", "rotation", "pca")},
    "bq": _bq_from,
    "tsvq": _tsvq_from,
    "pq": lambda config, arrays, device: _pq_from(arrays, config["distance"], device),
    "pq_aniso": _pq_aniso_from,
    "opq": _opq_from,
    "sq": _sq_from,
    "sq_perdim": _sq_perdim_from,
    "pq_index": _pq_index_from,
    "ivfpq_index": _ivfpq_from,
    "ivfflat_index": _ivfflat_from,
    "ivfsq_index": _ivfsq_from,
    "rq": lambda config, arrays, device: _rq_from(arrays, device),
    "rq_index": _rq_index_from,
    "ivfrq_index": _ivfrq_from,
    "ivfbinary_index": _ivfbinary_from,
    "flat_index": _flat_index_from,
    "sq_index": _sq_index_from,
    "binary_index": _binary_index_from,
}


def from_state(kind: str, config: Dict[str, Any], arrays: Dict[str, Any],
               device=None, base=None):
    """Rebuild a port object from ``(kind, config, arrays)`` on ``device``;
    a wrapper kind takes its loaded base index as ``base``."""
    if kind in _WRAPPERS:
        if base is None:
            raise InvalidData(f"a {kind} checkpoint needs its base index")
        return _WRAPPERS[kind](config, arrays, resolve_device(device), base)
    if kind not in _FROM_STATE:
        raise InvalidData(f"unknown checkpoint kind {kind!r}")
    return _FROM_STATE[kind](config, arrays, resolve_device(device))
