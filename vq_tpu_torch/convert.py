"""Trained state across packages: a model as ``(kind, config, arrays)``.

This is the layout of the single-file ``.npz`` checkpoints that both
packages write (``vq_tpu.utils.serialize``): ``kind`` names the class,
``config`` holds its settings as JSON values and ``arrays`` its numpy
arrays. The JAX package's parameters, taken as numpy arrays, become the
port's objects through :func:`from_state`, and :func:`state_of` gives the
port's state back in the same form, so a model moves either way without
JAX being imported here.

Kinds ported so far: ``"pq"`` (:class:`ProductQuantizer`: config
``distance``, array ``codebooks``), ``"pq_index"`` (:class:`PQIndex`:
config ``distance``, ``keep_corpus``, ``pack_bits``; arrays
``codebooks``, ``codes`` and, when kept, ``corpus``) and
``"ivfpq_index"`` (:class:`IVFPQIndex`: config ``by_residual``,
``keep_corpus``, ``max_list_size``, ``metric``; arrays ``coarse``,
``codebooks``, ``flat_codes`` and ``flat_lists`` in id order, and, when
kept, ``corpus``). A JAX ``IVFPQIndex`` carries across as
``from_state("ivfpq_index", config, {"coarse": ..., "codebooks": ...,
"flat_codes": ..., "flat_lists": ...})``: the port's index holds the
same lists and codes in the same pool layout, so it computes the same
search.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import InvalidData, InvalidParameter

State = Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(t)


def state_of(obj) -> State:
    """``(kind, config, arrays)`` of a :class:`ProductQuantizer`,
    :class:`PQIndex` or :class:`IVFPQIndex`, arrays as numpy."""
    from vq_tpu_torch.ivf import IVFPQIndex
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.search import PQIndex

    if isinstance(obj, IVFPQIndex):
        empty = obj._pool is None or obj._pool.n_rows == 0
        arrays = {
            "coarse": _np(obj.coarse),
            "codebooks": _np(obj.pq.codebooks),
            "flat_codes": (
                np.zeros((0, obj.pq.num_subspaces), np.int32) if empty
                else _np(obj._pool.to_flat(["codes"])["codes"])
            ),
            "flat_lists": (
                np.zeros((0,), np.int32) if obj._flat_lists is None
                else _np(obj._flat_lists)
            ),
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
    raise InvalidParameter(
        "quantizer", f"don't know how to serialize {type(obj).__name__}"
    )


def from_state(kind: str, config: Dict[str, Any], arrays: Dict[str, Any],
               device=None):
    """Rebuild a port object from ``(kind, config, arrays)`` on ``device``."""
    from vq_tpu_torch.ivf import IVFPQIndex
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.search import PQIndex

    device = torch.device("cpu" if device is None else device)
    if kind not in ("pq", "pq_index", "ivfpq_index"):
        raise InvalidData(f"unknown checkpoint kind {kind!r}")
    pq = ProductQuantizer(
        codebooks=np.asarray(arrays["codebooks"], np.float32),
        distance=("squared_euclidean" if kind == "ivfpq_index" else config["distance"]),
        device=device,
    )
    if kind == "pq":
        return pq
    if kind == "ivfpq_index":
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
            lists = torch.as_tensor(np.asarray(arrays["flat_lists"], np.int32), device=device)
            idx._pool_append(lists, torch.as_tensor(codes, device=device))
        if "corpus" in arrays:
            idx._corpus = torch.as_tensor(np.asarray(arrays["corpus"]), device=device)
        return idx
    # Checkpoints written before sub-byte packing carry no pack_bits.
    pack_bits = int(config.get("pack_bits", 8))
    idx = PQIndex(pq, keep_corpus=bool(config["keep_corpus"]), packed=pack_bits < 8)
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        idx._codes = torch.as_tensor(codes, device=device)
    if "corpus" in arrays:
        idx._corpus = torch.as_tensor(np.asarray(arrays["corpus"]), device=device)
    return idx
