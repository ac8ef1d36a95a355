"""Chunked inverted-list storage — the port of ``vq_tpu.ivf_pool``.

Every payload lives in ``[n_chunks, CH, *tail]`` tensors of fixed
``CH``-row chunks on the pool's device. A list owns a chain of chunk ids
(``chains [nlist, maxc]`` i32, -1-padded) and its rows fill the chain
densely, so storage is ``n * bytes a row`` plus at most one partial chunk
a list, whatever the skew. Appends scatter a batch into free slots in
place; capacity grows by doubling, and :meth:`ChunkPool.reserve`
preallocates for large builds. Search reads the pool directly: a probed
list is its chain's chunks (:func:`take_list_ids`,
:func:`take_list_payload`, and K7, which walks the chains itself).

Row ids are positional add order: ``pos [n]`` maps an id to its pool
slot and ``slot_ids [n_chunks, CH]`` maps slots back (-1 = empty).

The chains and list lengths are kept on the host (numpy) and uploaded
when a batch or a search needs them. Chunk allocation is vectorised, and
hands out the same ids in the same order as the JAX package's loop
(lists in ascending order, recycled ids popped off the free list
first), so chains, ``slot_ids`` and ``pos`` equal the JAX pool's.
Freeing, relabelling and removal (``free_lists``, ``relabel_lists``,
``remove``) are not ported yet; nothing here fills the free list.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["ChunkPool", "take_list_ids", "take_list_payload"]


def _cdiv(a, b):
    return -(-a // b)


def _round8(x: int) -> int:
    return max(8, _cdiv(int(x), 8) * 8)


def take_list_ids(slot_ids, chains_s, pl, cap: int) -> torch.Tensor:
    """Ids of lists ``pl`` as ``[..., maxc_s*CH]``, -1 wherever a slot is
    dead: past the chain, past the list, or past the ``cap`` search
    truncation (rows past ``max_list_size`` stay stored but unsearched)."""
    ch = slot_ids.shape[1]
    maxc_s = chains_s.shape[1]
    ct = chains_s[pl.to(torch.int64)]  # [..., maxc_s]
    ids = slot_ids[ct.clamp_min(0).to(torch.int64)]  # [..., maxc_s, CH]
    ids = torch.where((ct >= 0)[..., None], ids, -1)
    posm = (
        torch.arange(maxc_s, device=ids.device)[:, None] * ch
        + torch.arange(ch, device=ids.device)[None, :]
    ) < cap
    ids = torch.where(posm, ids, -1)
    return ids.reshape(ids.shape[:-2] + (maxc_s * ch,))


def take_list_payload(data, chains_s, pl) -> torch.Tensor:
    """Payload rows of lists ``pl`` as ``[..., maxc_s*CH, *tail]`` (dead
    slots carry whatever the chunk holds: mask with :func:`take_list_ids`)."""
    ch = data.shape[1]
    ct = chains_s[pl.to(torch.int64)]
    rows = data[ct.clamp_min(0).to(torch.int64)]
    return rows.reshape(ct.shape[:-1] + (ct.shape[-1] * ch,) + tuple(data.shape[2:]))


class ChunkPool:
    """Chunked inverted-list storage over named payload tensors.

    ``specs`` maps a payload name to ``(tail shape, torch dtype)``."""

    def __init__(
        self,
        specs: Dict[str, Tuple[tuple, torch.dtype]],
        nlist: int,
        *,
        chunk_rows: int = 256,
        max_list_size: Optional[int] = None,
        device=None,
    ):
        if max_list_size is not None:
            chunk_rows = min(chunk_rows, _round8(max_list_size))
        self.ch = int(chunk_rows)
        self.nlist = int(nlist)
        self.max_list_size = max_list_size
        self.device = torch.device("cpu" if device is None else device)
        self.specs = {k: (tuple(t), d) for k, (t, d) in specs.items()}
        self.n_rows = 0
        self._n_chunks = 0  # allocated pool capacity (chunks)
        self._free: List[int] = []  # recycled chunk ids
        self._tail = 0  # next never-used chunk id
        self.lens_h = np.zeros(self.nlist, np.int64)
        self._chains_h = np.full((self.nlist, 4), -1, np.int32)
        self._chains_dev: Optional[torch.Tensor] = None  # device copy, lazily
        self.data: Dict[str, torch.Tensor] = {}
        self.slot_ids: Optional[torch.Tensor] = None
        self.pos: Optional[torch.Tensor] = None

    # -- capacity ----------------------------------------------------------

    @property
    def maxc(self) -> int:
        """Longest chain (chunks) over all lists."""
        return int(_cdiv(int(self.lens_h.max()), self.ch)) if self.n_rows else 0

    @property
    def cap(self) -> int:
        """Searched rows a list: the longest list rounded up to 8, clipped
        to ``max_list_size`` rounded up to 8."""
        if self.n_rows == 0:
            return 8
        cap = _round8(int(self.lens_h.max()))
        if self.max_list_size is not None:
            cap = min(cap, _round8(self.max_list_size))
        return cap

    def chains_search(self) -> torch.Tensor:
        """Device chains cut (or -1-padded) to the search width
        ``cdiv(cap, CH)``."""
        if self._chains_dev is None:
            self._chains_dev = torch.as_tensor(self._chains_h, device=self.device)
        maxc_s = max(1, _cdiv(self.cap, self.ch))
        cur = self._chains_dev.shape[1]
        if cur >= maxc_s:
            return self._chains_dev[:, :maxc_s]
        return torch.nn.functional.pad(self._chains_dev, (0, maxc_s - cur), value=-1)

    def reserve(self, rows: int) -> None:
        """Preallocate capacity for ``rows`` total rows (plus one partial
        chunk a list), so appends never pay the doubling copy."""
        want = _cdiv(int(rows), self.ch) + self.nlist
        if want > self._n_chunks:
            self._grow_pool(want)
        if self.pos is None or rows > self.pos.shape[0]:
            self._grow_pos(int(rows))

    def _grow_pool(self, want_chunks: int) -> None:
        want = max(int(want_chunks), 2 * max(self._n_chunks, 4))
        for name, (tail, dt) in self.specs.items():
            new = torch.zeros((want, self.ch) + tail, dtype=dt, device=self.device)
            if name in self.data and self._n_chunks:
                new[: self._n_chunks] = self.data[name]
            self.data[name] = new
        new_ids = torch.full((want, self.ch), -1, dtype=torch.int32, device=self.device)
        if self.slot_ids is not None and self._n_chunks:
            new_ids[: self._n_chunks] = self.slot_ids
        self.slot_ids = new_ids
        self._n_chunks = want

    def _grow_pos(self, want_rows: int) -> None:
        want = max(int(want_rows), 2 * self.n_rows, 1024)
        new = torch.zeros((want,), dtype=torch.int32, device=self.device)
        if self.pos is not None and self.n_rows:
            new[: self.n_rows] = self.pos[: self.n_rows]
        self.pos = new

    def _alloc_chunks(self, total: int) -> np.ndarray:
        """``total`` chunk ids in the order one-at-a-time allocation gives:
        recycled ids off the end of the free list first, then fresh ones."""
        nf = min(total, len(self._free))
        recycled = self._free[len(self._free) - nf:][::-1]
        del self._free[len(self._free) - nf:]
        fresh = np.arange(self._tail, self._tail + total - nf)
        self._tail += total - nf
        return np.concatenate([np.asarray(recycled, np.int64), fresh]).astype(np.int32)

    # -- mutation ----------------------------------------------------------

    def append(self, lists, payloads: Dict[str, torch.Tensor]) -> None:
        """Scatter a batch into the pool in place: ``lists [nb]`` list ids,
        ``payloads`` name -> ``[nb, *tail]``; the rows get the next ``nb``
        ids. Row j of the batch goes to in-list position ``lens[l] +
        rank``, its rank among the batch's rows of list l in batch order."""
        lists = torch.as_tensor(lists, device=self.device).to(torch.int64)
        nb = int(lists.shape[0])
        if nb == 0:
            return
        counts = torch.bincount(lists, minlength=self.nlist).cpu().numpy()  # one sync
        lens = self.lens_h
        need = _cdiv(lens + counts, self.ch) - _cdiv(lens, self.ch)
        total = int(need.sum())
        if self._tail + max(0, total - len(self._free)) > self._n_chunks:
            self._grow_pool(self._tail + total - len(self._free))
        if self.pos is None or self.n_rows + nb > self.pos.shape[0]:
            self._grow_pos(self.n_rows + nb)
        new_maxc = int(_cdiv(lens + counts, self.ch).max())
        cur = self._chains_h.shape[1]
        if new_maxc > cur:
            self._chains_h = np.pad(
                self._chains_h, ((0, 0), (0, max(new_maxc, 2 * cur) - cur)),
                constant_values=-1,
            )
        grow = np.nonzero(need)[0]
        reps = need[grow]
        li = np.repeat(grow, reps)
        start = np.repeat(np.cumsum(reps) - reps, reps)
        cp = np.repeat(_cdiv(lens[grow], self.ch), reps) + np.arange(total) - start
        self._chains_h[li, cp] = self._alloc_chunks(total)
        self._chains_dev = None

        dev = self.device
        sl, order = torch.sort(lists, stable=True)
        starts = torch.searchsorted(sl, torch.arange(self.nlist, device=dev))
        rank = torch.arange(nb, device=dev) - starts[sl]
        pil = torch.as_tensor(lens, device=dev)[sl] + rank  # position in the list
        chains = torch.as_tensor(self._chains_h, device=dev).to(torch.int64)
        dest = chains[sl, pil // self.ch] * self.ch + pil % self.ch  # flat slot
        for name, (tail, dt) in self.specs.items():
            flat = self.data[name].view((-1,) + tail)
            flat[dest] = torch.as_tensor(payloads[name], device=dev)[order].to(dt)
        row_ids = torch.arange(self.n_rows, self.n_rows + nb, device=dev)[order]
        self.slot_ids.view(-1)[dest] = row_ids.to(torch.int32)
        self.pos[row_ids] = dest.to(torch.int32)
        self.n_rows += nb
        self.lens_h = lens + counts

    def gather_rows(self, name: str, ids) -> torch.Tensor:
        """Payload rows for global ids (any order)."""
        ids = torch.as_tensor(ids, device=self.device).to(torch.int64)
        data = self.data[name]
        flat = data.view((-1,) + tuple(data.shape[2:]))
        return flat[self.pos[ids].to(torch.int64)]

    def to_flat(self, names=None) -> Dict[str, torch.Tensor]:
        """Payloads in id order ``[n, *tail]``."""
        names = list(self.specs) if names is None else list(names)
        ids = torch.arange(self.n_rows, device=self.device)
        return {n: self.gather_rows(n, ids) for n in names}

    def stats(self) -> dict:
        """Occupancy and memory diagnostics."""
        used = self._tail - len(self._free)
        return {
            "chunk_rows": self.ch,
            "chunks_used": used,
            "chunks_allocated": self._n_chunks,
            "slack_rows": used * self.ch - int(self.lens_h.sum()),
        }
