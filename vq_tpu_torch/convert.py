"""Trained state across packages: a model as ``(kind, config, arrays)``.

This is the layout of the single-file ``.npz`` checkpoints that both
packages write (``vq_tpu.utils.serialize``): ``kind`` names the class,
``config`` holds its settings as JSON values and ``arrays`` its numpy
arrays. The JAX package's parameters, taken as numpy arrays, become the
port's objects through :func:`from_state`, and :func:`state_of` gives the
port's state back in the same form, so a model moves either way without
JAX being imported here.

Kinds of this slice: ``"pq"`` (:class:`ProductQuantizer`: config
``distance``, array ``codebooks``) and ``"pq_index"`` (:class:`PQIndex`:
config ``distance``, ``keep_corpus``, ``pack_bits``; arrays
``codebooks``, ``codes`` and, when kept, ``corpus``).
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
    """``(kind, config, arrays)`` of a :class:`ProductQuantizer` or
    :class:`PQIndex`, arrays as numpy."""
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.search import PQIndex

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
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.search import PQIndex

    device = torch.device("cpu" if device is None else device)
    if kind not in ("pq", "pq_index"):
        raise InvalidData(f"unknown checkpoint kind {kind!r}")
    pq = ProductQuantizer(
        codebooks=np.asarray(arrays["codebooks"], np.float32),
        distance=config["distance"], device=device,
    )
    if kind == "pq":
        return pq
    # Checkpoints written before sub-byte packing carry no pack_bits.
    pack_bits = int(config.get("pack_bits", 8))
    idx = PQIndex(pq, keep_corpus=bool(config["keep_corpus"]), packed=pack_bits < 8)
    codes = np.asarray(arrays["codes"])
    if codes.shape[0]:
        idx._codes = torch.as_tensor(codes, device=device)
    if "corpus" in arrays:
        idx._corpus = torch.as_tensor(np.asarray(arrays["corpus"]), device=device)
    return idx
