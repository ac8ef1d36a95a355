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
slot and ``slot_ids [n_chunks, CH]`` maps slots back (-1 = empty). Both
renumber on removal (the faiss ``remove_ids`` contract).

The chains and list lengths are kept on the host (numpy) and uploaded
when a batch or a search needs them. Chunk allocation is vectorised, and
hands out the same ids in the same order as the JAX package's loop
(lists in ascending order, recycled ids popped off the end of the free
list first), so after any sequence of appends, frees, relabels and
removals the chains, ``slot_ids``, ``pos`` and the free list equal the
JAX pool's.

Rebalance and removal move only the affected lists' chunks:
:meth:`ChunkPool.free_lists` returns a list's chunks to the free list,
:meth:`ChunkPool.relabel_lists` renumbers the lists, and
:meth:`ChunkPool.append` with ``row_ids`` puts rows back under the ids
they had. Every mutation drops the cached device chains and bumps
:attr:`ChunkPool.version`, the counter that caches of the search view key
on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import resolve_device

__all__ = ["ChunkPool", "bucket_stats", "take_list_ids", "take_list_payload"]


def _cdiv(a, b):
    return -(-a // b)


def _round8(x: int) -> int:
    return max(8, _cdiv(int(x), 8) * 8)


def _int_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for uint32 words (which PyTorch can copy but not
    scatter or gather everywhere) the same memory viewed as int32."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _zeros(shape, dtype, device) -> torch.Tensor:
    if dtype == torch.uint32:
        return torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32)
    return torch.zeros(shape, dtype=dtype, device=device)


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
    rows = _int_view(data)[ct.clamp_min(0).to(torch.int64)].view(data.dtype)
    return rows.reshape(ct.shape[:-1] + (ct.shape[-1] * ch,) + tuple(data.shape[2:]))


def bucket_stats(pool: "ChunkPool", ntotal: int) -> dict:
    """The IVF indexes' ``bucket_stats``: list-size distribution, the
    searched rows a list (``cap``), the rows a ``max_list_size`` cap
    leaves unsearched, and the probe slots that are dead
    (``padding_waste``), with the pool's own :meth:`ChunkPool.stats`."""
    counts = pool.lens_h
    cap = pool.cap
    return {
        "ntotal": int(ntotal),
        "nlist": pool.nlist,
        "cap": cap,
        "min": int(counts.min()),
        "mean": float(counts.mean()),
        "max": int(counts.max()),
        "empty_lists": int((counts == 0).sum()),
        "overflow_dropped": int(np.maximum(counts - cap, 0).sum()),
        "padding_waste": float(1.0 - int(np.minimum(counts, cap).sum()) / (pool.nlist * cap)),
        **pool.stats(),
    }


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
        self.device = resolve_device(device)
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
        self.version = 0  # bumped by every mutation

    def _mutated(self) -> None:
        self._chains_dev = None
        self.version += 1

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
            new = _zeros((want, self.ch) + tail, dt, self.device)
            if name in self.data and self._n_chunks:
                _int_view(new)[: self._n_chunks] = _int_view(self.data[name])
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

    def append(self, lists, payloads: Dict[str, torch.Tensor], row_ids=None) -> None:
        """Scatter a batch into the pool in place: ``lists [nb]`` list ids,
        ``payloads`` name -> ``[nb, *tail]``. The rows get the next ``nb``
        ids, or the given ``row_ids [nb]`` (then ``n_rows`` stays as it
        is: rebalance and removal put rows back under their ids). Row j of
        the batch goes to in-list position ``lens[l] + rank``, its rank
        among the batch's rows of list l in batch order."""
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
        self._mutated()

        dev = self.device
        sl, order = torch.sort(lists, stable=True)
        starts = torch.searchsorted(sl, torch.arange(self.nlist, device=dev))
        rank = torch.arange(nb, device=dev) - starts[sl]
        pil = torch.as_tensor(lens, device=dev)[sl] + rank  # position in the list
        chains = torch.as_tensor(self._chains_h, device=dev).to(torch.int64)
        dest = chains[sl, pil // self.ch] * self.ch + pil % self.ch  # flat slot
        for name, (tail, dt) in self.specs.items():
            flat = _int_view(self.data[name].view((-1,) + tail))
            flat[dest] = _int_view(torch.as_tensor(payloads[name], device=dev).to(dt))[order]
        if row_ids is None:
            row_ids = torch.arange(self.n_rows, self.n_rows + nb, device=dev)[order]
            self.n_rows += nb
        else:
            row_ids = torch.as_tensor(row_ids, device=dev).to(torch.int64)[order]
        self.slot_ids.view(-1)[dest] = row_ids.to(torch.int32)
        self.pos[row_ids] = dest.to(torch.int32)
        self.lens_h = lens + counts

    def gather_rows(self, name: str, ids) -> torch.Tensor:
        """Payload rows for global ids (any order)."""
        ids = torch.as_tensor(ids, device=self.device).to(torch.int64)
        data = self.data[name]
        flat = _int_view(data.view((-1,) + tuple(data.shape[2:])))
        return flat[self.pos[ids].to(torch.int64)].view(data.dtype)

    def to_flat(self, names=None) -> Dict[str, torch.Tensor]:
        """Payloads in id order ``[n, *tail]``."""
        names = list(self.specs) if names is None else list(names)
        ids = torch.arange(self.n_rows, device=self.device)
        return {n: self.gather_rows(n, ids) for n in names}

    def free_lists(self, list_ids) -> None:
        """Drop every chunk of the given lists (gather their rows first):
        the chunks' slots go to -1 and the chunks onto the free list, in
        chain order, list by list."""
        list_ids = np.asarray(list_ids, np.int64).reshape(-1)
        _, first = np.unique(list_ids, return_index=True)
        list_ids = list_ids[np.sort(first)]
        chains = self._chains_h[list_ids]
        freed = chains[chains >= 0]
        self._chains_h[list_ids] = -1
        self.lens_h[list_ids] = 0
        self._mutated()
        if not freed.size:
            return
        self.slot_ids[torch.as_tensor(freed, device=self.device).to(torch.int64)] = -1
        self._free.extend(int(c) for c in freed)

    def relabel_lists(self, remap, new_nlist: int) -> None:
        """Renumber the lists (rebalance's retire-compaction): old list
        ``l`` becomes ``remap[l]``; ``remap[l] = -1`` retires a list,
        which must be empty by then (:meth:`free_lists`)."""
        remap = np.asarray(remap, np.int64)
        kept = remap >= 0
        if bool((self.lens_h[~kept] > 0).any()):
            raise InvalidParameter("remap", "a retired list still holds rows: free it first")
        new_chains = np.full((int(new_nlist), self._chains_h.shape[1]), -1, np.int32)
        new_lens = np.zeros(int(new_nlist), np.int64)
        new_chains[remap[kept]] = self._chains_h[kept]
        new_lens[remap[kept]] = self.lens_h[kept]
        self._chains_h, self.lens_h = new_chains, new_lens
        self.nlist = int(new_nlist)
        self._mutated()

    def remove(self, removed_sorted, lists_np) -> None:
        """Remove rows by id (``removed_sorted``: sorted, unique); the rest
        renumber positionally. ``lists_np`` holds every row's list before
        the removal. Only the lists that held removed rows repack: their
        survivors are gathered, the lists freed, and the survivors
        appended again in ascending id order under their new ids."""
        removed = np.asarray(removed_sorted, np.int64)
        if removed.size == 0:
            return
        lists_np = np.asarray(lists_np)
        aff_lists = np.unique(lists_np[removed])
        keep = np.ones(self.n_rows, bool)
        keep[removed] = False
        aff_rows = np.where(np.isin(lists_np, aff_lists) & keep)[0]
        new_ids = aff_rows - np.searchsorted(removed, aff_rows)
        payloads = {n: self.gather_rows(n, aff_rows) for n in self.specs}
        n_new = self.n_rows - int(removed.size)
        self._renumber(torch.as_tensor(removed, device=self.device), n_new)
        self.n_rows = n_new
        self.free_lists(aff_lists)
        self.append(lists_np[aff_rows], payloads, row_ids=new_ids)

    def _renumber(self, removed: torch.Tensor, n_new: int) -> None:
        """On the pool's device: every surviving slot id drops by the number
        of removed ids below it, removed ids' slots go to -1, and ``pos``
        is rebuilt from the renumbered slots (``[n_new]``)."""
        r = removed.shape[0]
        ids = self.slot_ids.to(torch.int64)
        safe = ids.clamp_min(0)
        shift = torch.searchsorted(removed, safe, side="left")
        hit = removed[shift.clamp_max(r - 1)] == safe
        valid = (ids >= 0) & ~((shift < r) & hit)
        new = torch.where(valid, ids - shift, -1)
        self.slot_ids = new.to(torch.int32)
        flat = new.reshape(-1)
        tgt = torch.where(flat >= 0, flat, n_new)  # dead slots land past the end
        pos = torch.zeros((n_new + 1,), dtype=torch.int32, device=self.device)
        pos[tgt] = torch.arange(flat.shape[0], dtype=torch.int32, device=self.device)
        self.pos = pos[:n_new]
        self._mutated()

    def stats(self) -> dict:
        """Occupancy and memory diagnostics."""
        used = self._tail - len(self._free)
        return {
            "chunk_rows": self.ch,
            "chunks_used": used,
            "chunks_allocated": self._n_chunks,
            "slack_rows": used * self.ch - int(self.lens_h.sum()),
        }
