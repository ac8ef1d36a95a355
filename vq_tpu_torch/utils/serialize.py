"""Save / load in the JAX package's single-file ``.npz`` format, so a
checkpoint written by either package loads in the other: a JSON header
(``format_version``, ``kind``, ``config``) stored as a u8 array under
``__vq_header__``, then the model's arrays by name. The port carries
the kinds ``"pq"``, ``"pq_aniso"``, ``"opq"``, ``"sq"``, ``"sq_perdim"``,
``"rq"``, ``"bq"``, ``"tsvq"`` (:func:`save` /
:func:`load`), ``"kmeans_harness"`` (``Kmeans.save`` / ``load``), the
indexes of :data:`INDEX_KINDS` (each index's ``save`` / ``load``, and
:func:`vq_tpu_torch.factory.load_index`); the layouts are listed in
:mod:`vq_tpu_torch.convert`.

A wrapper index (:data:`WRAPPER_KINDS`) is two files, as in the JAX
package: ``save(path, wrapper)`` writes the base first to
``<path>.base.npz`` and names it in the wrapper's config as
``base_file``; :func:`load` reads that file beside the wrapper's."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from vq_tpu_torch.convert import from_state, state_of
from vq_tpu_torch.errors import InvalidData

_FORMAT_VERSION = 1
# Index kinds (what ``load_index`` reads) and, among them, the wrappers
# whose base index sits in a file of its own.
WRAPPER_KINDS = ("transformed_index", "refine_index", "idmap_index")
INDEX_KINDS = ("flat_index", "pq_index", "binary_index", "sq_index", "rq_index",
               "ivfpq_index", "ivfflat_index", "ivfsq_index", "ivfrq_index",
               "ivfbinary_index") + WRAPPER_KINDS


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
    appended if absent), a wrapper's base beside it; returns the path."""
    kind, config, arrays = state_of(model)
    if kind in WRAPPER_KINDS:
        if not path.endswith(".npz"):
            path = path + ".npz"
        base_path = save(path[: -len(".npz")] + ".base.npz", model.base)
        config = {**config, "base_file": os.path.basename(base_path)}
    return _to_npz(path, kind, config, arrays)


def load(path: str, device=None, *, expect=None):
    """Load a model saved by either package onto ``device`` (a wrapper
    with the base checkpoint its config names); with ``expect``, only a
    checkpoint of that kind."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    kind, config, arrays = _from_npz(path)
    if expect is not None and kind != expect:
        raise InvalidData(f"expected a {expect} checkpoint, got {kind!r}")
    base = None
    if kind in WRAPPER_KINDS:
        base = load(os.path.join(os.path.dirname(path), config["base_file"]), device)
    return from_state(kind, config, arrays, device=device, base=base)
