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
* ``"sq"`` — :class:`ScalarQuantizer` (``min``, ``max``, ``levels``; none);
* ``"sq_perdim"`` — :class:`PerDimScalarQuantizer` (``levels``; ``mins``,
  ``maxs``);
* ``"pq_index"`` — :class:`PQIndex` (``distance``, ``keep_corpus``,
  ``pack_bits``; ``codebooks``, ``codes`` and, when kept, ``corpus``);
* ``"ivfpq_index"`` — :class:`IVFPQIndex` (``by_residual``,
  ``keep_corpus``, ``max_list_size``, ``metric``; ``coarse``,
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
* ``"ivfrq_index"`` — :class:`IVFRQIndex` (``metric``, ``by_residual``,
  ``beam``, ``max_list_size``; ``coarse``, ``codebooks``, ``codes``,
  ``sqn``, ``cross`` and ``lists`` in id order).

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


def _lists(idx) -> np.ndarray:
    return np.zeros((0,), np.int32) if idx._flat_lists is None else _np(idx._flat_lists)


def _pool_flat(idx, name: str, empty: np.ndarray) -> np.ndarray:
    """Payload ``name`` of an IVF index in id order (``empty`` if none)."""
    if idx._pool is None or idx._pool.n_rows == 0:
        return empty
    return idx._pool.to_flat([name])[name]


def state_of(obj) -> State:
    """``(kind, config, arrays)`` of a port object, arrays as numpy."""
    from vq_tpu_torch.ivf import IVFPQIndex
    from vq_tpu_torch.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex
    from vq_tpu_torch.models.bq import BinaryQuantizer
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.models.rq import ResidualQuantizer
    from vq_tpu_torch.models.sq import PerDimScalarQuantizer, ScalarQuantizer
    from vq_tpu_torch.models.tsvq import TSVQ
    from vq_tpu_torch.search import PQIndex, RQIndex

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


def _ivfpq_from(config, arrays, device):
    from vq_tpu_torch.ivf import IVFPQIndex

    idx = IVFPQIndex(
        np.asarray(arrays["coarse"], np.float32), _pq_from(arrays, "squared_euclidean", device),
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


_FROM_STATE = {
    "bq": _bq_from,
    "tsvq": _tsvq_from,
    "pq": lambda config, arrays, device: _pq_from(arrays, config["distance"], device),
    "sq": _sq_from,
    "sq_perdim": _sq_perdim_from,
    "pq_index": _pq_index_from,
    "ivfpq_index": _ivfpq_from,
    "ivfflat_index": _ivfflat_from,
    "ivfsq_index": _ivfsq_from,
    "rq": lambda config, arrays, device: _rq_from(arrays, device),
    "rq_index": _rq_index_from,
    "ivfrq_index": _ivfrq_from,
}


def from_state(kind: str, config: Dict[str, Any], arrays: Dict[str, Any],
               device=None):
    """Rebuild a port object from ``(kind, config, arrays)`` on ``device``."""
    if kind not in _FROM_STATE:
        raise InvalidData(f"unknown checkpoint kind {kind!r}")
    return _FROM_STATE[kind](config, arrays, resolve_device(device))
