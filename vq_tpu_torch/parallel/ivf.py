"""Sharded IVF-PQ search — inverted lists sharded over the mesh's data
axis; the port of ``vq_tpu.parallel.ivf``.

The layout is :mod:`vq_tpu_torch.parallel.ivf_scan`'s (the reference's
``_shard_lists``): rank ``s`` owns lists ``[s·L, (s+1)·L)`` and holds
their chunks of the code pool, in chain order, as its block on its
device; the coarse centroids, codebooks and queries replicate. Per query
batch every rank computes the same probe set and ADC tables, runs the
single-device probe (:func:`vq_tpu_torch.ivf._probe_dists`: K7 over the
block, through a ``[nlist, maxc]`` view of the chains whose other ranks'
lists are all -1), keeps a local top-k, and merges with one
``all_gather`` and a top-k over the concatenation in rank order. Dot
tables and the ``q·c_probe`` offset stay as the single-device search
has them (smaller is better inside; scores negated back at the end).
Communication is ``O(D · Q · k)``, independent of the corpus.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput
from vq_tpu_torch.ivf import IVFPQIndex, _probe_dists, _topk
from vq_tpu_torch.ivf_flat import _pad_to_k
from vq_tpu_torch.models.base import as_batch_f32
from vq_tpu_torch.parallel.ivf_scan import _shard_lists
from vq_tpu_torch.parallel.mesh import DATA_AXIS, _sharded, make_mesh, merge_topk, mesh_device

__all__ = ["sharded_ivf_search", "sharded_ivf_search_core", "shard_buckets"]


def shard_buckets(index, mesh: Optional[DeviceMesh] = None):
    """Place an IVF index's code pool list-sharded on the mesh's data axis
    -> ``(slot_ids, codes, chains, cap, mesh)``: the first three are
    DTensors sharded over the data axis with the reference's global shapes
    ``[D·M, CH]``, ``[D·M, CH, m]`` and ``[nlist_pad, maxc]`` (block-local
    chunk ids), each rank holding its own block on its device. Cached on
    the index per (mesh, pool, ``ChunkPool.version``)."""
    if index._flat_lists is None:
        raise EmptyInput("index is empty — add() vectors first")
    if mesh is None:
        mesh = make_mesh()
    b = _shard_lists(mesh, index, ("codes",))
    place = [Shard(0), Replicate()]
    ids, codes = b.ids, b.payloads["codes"]
    rows = b.ndev * ids.shape[0]
    return (_sharded(ids, mesh, (rows,) + tuple(ids.shape[1:]), place),
            _sharded(codes, mesh, (rows,) + tuple(codes.shape[1:]), place),
            _sharded(b.chains_local, mesh, (b.nlist_pad, b.chains_local.shape[1]), place),
            b.cap, mesh)


def sharded_ivf_search(
    index,
    queries,
    k: int = 10,
    *,
    nprobe: int = 8,
    mesh: Optional[DeviceMesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search an :class:`~vq_tpu_torch.IVFPQIndex` with its inverted lists
    sharded over the mesh -> ``(ids [Q, k] i32, values [Q, k])``, the
    same on every rank and the single-device search's up to exact ties
    that straddle ranks: squared-L2 ascending (-1 / inf pads) or, for
    ``metric="dot"``, scores descending (-1 / -inf pads). Every rank calls
    it with the same index and queries."""
    fn, arrays = sharded_ivf_search_core(index, int(k), nprobe=nprobe, mesh=mesh)
    q, _ = as_batch_f32(queries, arrays[0].device)
    if q.shape[1] != index.pq.dim:
        raise DimensionMismatch(expected=index.pq.dim, found=q.shape[1])
    return fn(q, *arrays)


def sharded_ivf_search_core(
    index,
    k: int,
    *,
    nprobe: int = 8,
    mesh: Optional[DeviceMesh] = None,
):
    """:func:`sharded_ivf_search` as an ``(fn, arrays)`` pair, the sharded
    form of :meth:`IVFPQIndex._search_core`: ``arrays`` are the coarse
    centroids, the codebooks and this rank's block (ids, codes, the search
    view of the chains) on the rank's device; ``fn(q, *arrays)`` runs the
    local probe and the merge, every rank together
    (``BatchPipeline.from_core`` can drive it)."""
    if not isinstance(index, IVFPQIndex):
        raise TypeError("sharded_ivf_search serves IVFPQIndex; got "
                        f"{type(index).__name__} (use sharded_ivf_scan_search)")
    if index._flat_lists is None:
        raise EmptyInput("index is empty — add() vectors first")
    if mesh is None:
        mesh = make_mesh()
    b = _shard_lists(mesh, index, ("codes",))
    dev = mesh_device(mesh)
    k = int(k)
    nprobe = min(int(nprobe), index.nlist)
    kk = min(k, nprobe * b.view_chains.shape[1] * b.ids.shape[1])
    metric, by_residual, cap = index.metric, index.by_residual, b.cap
    group = mesh.get_group(DATA_AXIS)

    def fn(q, coarse, cbs, ids, codes, chains):
        li, ld = _topk(*_probe_dists(q, coarse, cbs, codes, ids, chains, nprobe, cap,
                                     by_residual, metric), kk)
        out_i, out_d = _pad_to_k(*merge_topk(li, ld, kk, group), k)
        return (out_i, -out_d) if metric == "dot" else (out_i, out_d)

    return fn, (index.coarse.to(dev), index.pq.codebooks.to(dev), b.ids, b.payloads["codes"],
                b.view_chains)
