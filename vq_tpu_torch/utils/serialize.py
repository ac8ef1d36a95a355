"""Save / load in the JAX package's single-file ``.npz`` format, so a
checkpoint written by either package loads in the other: a JSON header
(``format_version``, ``kind``, ``config``) stored as a u8 array under
``__vq_header__``, then the model's arrays by name. The port carries
the kinds ``"pq"``, ``"pq_aniso"``, ``"opq"``, ``"sq"``, ``"sq_perdim"``,
``"rq"``, ``"bq"``, ``"tsvq"`` (:func:`save` /
:func:`load`), ``"flat_index"``, ``"pq_index"``, ``"sq_index"``,
``"binary_index"``, ``"rq_index"``, ``"ivfpq_index"``,
``"ivfflat_index"``, ``"ivfsq_index"``, ``"ivfrq_index"`` and
``"ivfbinary_index"`` (each index's
``save`` / ``load``); the layouts are listed in
:mod:`vq_tpu_torch.convert`."""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from vq_tpu_torch.convert import from_state, state_of
from vq_tpu_torch.errors import InvalidData

_FORMAT_VERSION = 1


def _to_npz(path: str, kind: str, config: Dict[str, Any],
            arrays: Dict[str, np.ndarray]) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    header = json.dumps(
        {"format_version": _FORMAT_VERSION, "kind": kind, "config": config}
    )
    np.savez(
        path,
        __vq_header__=np.frombuffer(header.encode(), dtype=np.uint8),
        **{k: np.asarray(v) for k, v in arrays.items()},
    )
    return path


def _from_npz(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        if "__vq_header__" not in z:
            raise InvalidData(f"{path} is not a vq_tpu checkpoint")
        header = json.loads(bytes(z["__vq_header__"]).decode())
        if header.get("format_version") != _FORMAT_VERSION:
            raise InvalidData(
                f"unsupported checkpoint version {header.get('format_version')}"
            )
        arrays = {k: z[k] for k in z.files if k != "__vq_header__"}
    return header["kind"], header["config"], arrays


def save(path: str, model) -> str:
    """Write a quantizer or index of the port to ``path`` (``.npz``
    appended if absent); returns the path."""
    return _to_npz(path, *state_of(model))


def load(path: str, device=None):
    """Load a model saved by either package onto ``device``."""
    return from_state(*_from_npz(path), device=device)
