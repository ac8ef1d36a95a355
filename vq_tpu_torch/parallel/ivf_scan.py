"""Sharded IVF-Flat / IVF-SQ / IVF-RQ / IVF-Binary search — inverted lists
sharded over the mesh's data axis; the port of ``vq_tpu.parallel.ivf_scan``.

The JAX package's layout (``_shard_lists``): with ``D`` ranks on the data
axis and ``nlist`` padded to a multiple of ``D``, rank ``s`` owns the
``L = nlist_pad / D`` lists ``[s·L, (s+1)·L)``; its block of the chunk
pool holds exactly those lists' chunks, in chain order, padded to the
largest block with -1-id chunks, and its chains are block-local. Each
rank copies only its own block (ids, payloads) to its device; the index
may stay on the host. The coarse centroids, quantizer parameters and
queries replicate.

Per query batch:

1. **Local probe** — every rank computes the same top-``nprobe`` lists
   and runs the index's own single-device probe (``_probe``: K6 for
   IVF-Flat and IVF-SQ, K7 for IVF-RQ, the plain Hamming count for
   IVF-Binary, as in :mod:`vq_tpu_torch.ivf_flat`) over its block. Its
   search view indexes chains by the global list id: ``[nlist, maxc]``,
   block-local chunk ids for its own lists and -1 for every other one,
   so an out-of-shard probe is all dead slots (-1 ids, inf distances) and
   costs the kernels nothing. The reference clamps and masks instead.
2. **Merge** — a local top-k (:func:`_smallest`), one ``dist.all_gather``
   on the data group of values and ids packed in one int32 buffer, and
   one :func:`_smallest` over the concatenation in rank order: the lowest
   rank wins exact ties, as the reference's lowest device does. Then the
   reference's epilogue: -1 where the distance is inf, padding to k, and
   scores negated back for ``metric="dot"``.

The blocks are cached on the index per (mesh, chunk pool,
``ChunkPool.version``): every mutation of the pool (``add``,
``remove_ids``, ``merge_from``, ``rebalance``) rebuilds them. The
reference keys its cache on the identity of ``slot_ids``, which a
relabel-only ``rebalance(min_size=1)`` keeps, so its sharded search then
reads stale chains (``ROADMAP.md``, R3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput
from vq_tpu_torch.ivf_binary import IVFBinaryIndex
from vq_tpu_torch.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex, _pad_to_k
from vq_tpu_torch.ivf_pool import _int_view
from vq_tpu_torch.models.base import as_batch_f32
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.parallel.flat import _on
from vq_tpu_torch.parallel.mesh import DATA_AXIS, _coords, make_mesh, merge_topk, mesh_device

__all__ = ["sharded_ivf_scan_search", "sharded_scan_search_core"]

_SCAN_KINDS = (IVFFlatIndex, IVFSQIndex, IVFRQIndex, IVFBinaryIndex)


class _Blocks:
    """One rank's part of the list-sharded pool: ``ids [M, CH]`` and
    ``payloads`` (name -> ``[M, CH, *tail]``) of its block, its block-local
    chains ``[L, maxc]`` (the reference's shard of ``[nlist_pad, maxc]``),
    the search view ``view_chains [nlist, maxc]``, and the layout's sizes."""

    def __init__(self, ids, payloads, chains_local, view_chains, *, ndev, nlist_pad, cap):
        self.ids, self.payloads = ids, payloads
        self.chains_local, self.view_chains = chains_local, view_chains
        self.ndev, self.nlist_pad, self.cap = ndev, nlist_pad, cap


def _layout(chains_h: np.ndarray, nlist: int, ndev: int, maxc: int):
    """The reference's block layout on the host -> ``(perm [D, M]`` global
    chunk ids of each block, -1 pads; ``local [nlist, maxc]`` each list's
    block-local chunk ids, -1 pads; ``nlist_pad)``. A chain is a dense
    prefix, so a block's chunks in list-then-chain order are its lists'
    rows of ``chains_h`` read row-major."""
    nlist_pad = -(-nlist // ndev) * ndev
    per = nlist_pad // ndev
    chains = np.full((nlist, maxc), -1, np.int64)
    w = min(maxc, chains_h.shape[1])
    chains[:, :w] = chains_h[:nlist, :w]
    live = chains >= 0
    local = np.full((nlist, maxc), -1, np.int32)
    blocks = []
    for s in range(ndev):
        lo, hi = min(s * per, nlist), min((s + 1) * per, nlist)
        m = live[lo:hi]
        local[lo:hi][m] = np.arange(int(m.sum()), dtype=np.int32)
        blocks.append(chains[lo:hi][m])
    width = max(1, max(b.size for b in blocks))
    perm = np.full((ndev, width), -1, np.int64)
    for s, b in enumerate(blocks):
        perm[s, :b.size] = b
    return perm, local, nlist_pad


def _shard_lists(mesh: DeviceMesh, index, payload_names) -> _Blocks:
    """This rank's :class:`_Blocks` of ``index``'s pool, copied to its
    device; cached on the index per (mesh, pool, ``pool.version``)."""
    pool = index._pool
    cache = getattr(index, "_shard_cache", None)
    if (cache is not None and cache[0] is mesh and cache[1] is pool
            and cache[2] == pool.version and cache[3] == tuple(payload_names)):
        return cache[4]
    di, dn, _, _ = _coords(mesh)
    dev = mesh_device(mesh)
    maxc = max(1, -(-pool.cap // pool.ch))
    perm, local, nlist_pad = _layout(pool._chains_h, pool.nlist, dn, maxc)
    mine = torch.as_tensor(perm[di], device=pool.slot_ids.device)
    alive = (mine >= 0)[:, None]
    safe = mine.clamp_min(0)
    ids = torch.where(alive, pool.slot_ids[safe], -1).to(dev)
    payloads = {}
    for name in payload_names:
        data = pool.data[name]
        payloads[name] = _int_view(data)[safe].view(data.dtype).to(dev)
    per = nlist_pad // dn
    lo, hi = min(di * per, pool.nlist), min((di + 1) * per, pool.nlist)
    chains_local = np.full((per, maxc), -1, np.int32)
    chains_local[:hi - lo] = local[lo:hi]
    view = np.full((pool.nlist, maxc), -1, np.int32)
    view[lo:hi] = local[lo:hi]
    out = _Blocks(ids, payloads, torch.as_tensor(chains_local, device=dev),
                  torch.as_tensor(view, device=dev), ndev=dn, nlist_pad=nlist_pad, cap=pool.cap)
    index._shard_cache = (mesh, pool, pool.version, tuple(payload_names), out)
    return out


def _rank_view(index, dev: torch.device):
    """A shallow copy of ``index`` whose coarse centroids and quantizer
    live on ``dev`` (the pool stays where it is: the search reads the
    rank's block instead)."""
    view = _on(index, dev, skip=("_flat_lists",))
    for name in ("sq", "rq", "bq"):
        if hasattr(index, name):
            setattr(view, name, _on(getattr(index, name), dev))
    return view


def sharded_ivf_scan_search(
    index,
    queries,
    k: int = 10,
    *,
    nprobe: int = 8,
    mesh: Optional[DeviceMesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search an :class:`IVFFlatIndex` / :class:`IVFSQIndex` /
    :class:`IVFRQIndex` / :class:`IVFBinaryIndex` with its inverted lists
    sharded over the mesh's data axis -> ``(ids [Q, k] i32, values [Q,
    k])``, the same on every rank: the single-device search up to exact
    ties that straddle ranks (the single-device merge prefers earlier
    probe ranks, this one lower ranks; the values agree). Squared-L2
    ascending with inf pads, or for ``metric="dot"`` scores descending
    with -inf pads; ids of -1 where the probed lists held fewer than
    ``k`` rows. Every rank calls it with the same index and queries."""
    fn, arrays = sharded_scan_search_core(index, int(k), nprobe=nprobe, mesh=mesh)
    q, _ = as_batch_f32(queries, arrays[0].device)
    if q.shape[1] != index.dim:
        raise DimensionMismatch(expected=index.dim, found=q.shape[1])
    return fn(q, *arrays)


def sharded_scan_search_core(
    index,
    k: int,
    *,
    nprobe: int = 8,
    mesh: Optional[DeviceMesh] = None,
):
    """:func:`sharded_ivf_scan_search` as an ``(fn, arrays)`` pair, the
    sharded form of the indexes' ``_search_core``: ``arrays`` are the
    coarse centroids and this rank's block (its ids, the scanned payloads
    and the search view of the chains) on the rank's device, and ``fn(q,
    *arrays)`` runs the local probe and the merge; every rank calls it
    together (``BatchPipeline.from_core`` can drive it). Cached on the
    index per (mesh, pool, ``ChunkPool.version``)."""
    if not isinstance(index, _SCAN_KINDS):
        raise TypeError(
            "sharded_ivf_scan_search serves IVFFlatIndex / IVFSQIndex / IVFRQIndex / "
            f"IVFBinaryIndex; got {type(index).__name__} (use sharded_ivf_search for IVFPQIndex)")
    if index._flat_lists is None:
        raise EmptyInput("index is empty — add() vectors first")
    if mesh is None:
        mesh = make_mesh()
    k = int(k)
    nprobe = min(int(nprobe), index.nlist)
    names = tuple(index._scan_payloads)
    blocks = _shard_lists(mesh, index, names)
    dev = mesh_device(mesh)
    view = _rank_view(index, dev)
    cap, group, dot = blocks.cap, mesh.get_group(DATA_AXIS), index.metric == "dot"
    kk = min(k, nprobe * blocks.view_chains.shape[1] * blocks.ids.shape[1])

    def fn(q, coarse, ids, chains, *payloads):
        b = dict(zip(names, payloads), coarse=coarse, ids=ids, chains=chains)
        li, ld = view._probe(q, b, nprobe, cap)
        lv, pos = _smallest(ld, kk)
        out_i, out_d = merge_topk(torch.gather(li, 1, pos), lv, kk, group)
        out_i, out_d = _pad_to_k(out_i, out_d, k)
        return (out_i, -out_d) if dot else (out_i, out_d)

    arrays = (view.coarse, blocks.ids, blocks.view_chains) + tuple(
        blocks.payloads[n] for n in names)
    return fn, arrays
