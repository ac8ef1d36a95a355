"""Generic checkpoint loader and ID mapping — the port of
``vq_tpu.factory``'s :func:`load_index` and :class:`IdMapIndex`.

* :func:`load_index` — read any saved index back without knowing its
  type (the ``faiss.read_index`` analog; every index's ``save`` tags its
  checkpoint kind), a wrapper with the base checkpoint it names.
* :class:`IdMapIndex` — user-assigned int64 ids over any positional
  index (``add_with_ids``), the faiss ``IndexIDMap`` analog.

``index_factory`` and its spec parsers are not ported yet: they build
``GraphIndex`` too, which the port does not have.
"""

from __future__ import annotations

import numpy as np
import torch

from vq_tpu_torch.errors import EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor
from vq_tpu_torch.utils.serialize import INDEX_KINDS, _from_npz, load, save

__all__ = ["load_index", "IdMapIndex"]


def load_index(path: str, device=None):
    """Load any index saved by either package onto ``device``, dispatching
    on the checkpoint kind (``transformed_index``, ``refine_index`` and
    ``idmap_index`` load their base from the file they name)."""
    kind, _, _ = _from_npz(path)
    if kind == "graph_index":
        raise InvalidData(
            "graph_index checkpoints need GraphIndex, which vq_tpu_torch does not have yet")
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
