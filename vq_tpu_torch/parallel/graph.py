"""Sharded :class:`~vq_tpu_torch.GraphIndex` search — query-parallel over
the mesh's data axis; the port of ``vq_tpu.parallel.graph``.

Beam search walks the graph independently for each query, so the layout
is the transpose of the list-sharded IVF search: every rank holds the
whole index (rows, norms, adjacency, routing sample, entries) on its
device, and the query batch splits over the data axis, ``ceil(Q / D)``
rows a rank (zero rows pad the last). Each rank runs the single-device
search (:func:`vq_tpu_torch.graph._run_search`) on its rows, and one
``all_gather`` gives every rank the whole ``[Q, k]``, the pad trimmed.

The placement is cached on the index per mesh, so a serving loop copies
the index once; :meth:`GraphIndex.add` and :meth:`GraphIndex.remove_ids`
drop the cache. Replication costs ``n · (d · width + 8 · degree)``
bytes a device; a corpus too large for that is sharded into independent
indexes and merged as the flat search does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput
from vq_tpu_torch.graph import GraphIndex, _run_search
from vq_tpu_torch.models.base import as_batch_f32
from vq_tpu_torch.parallel.mesh import DATA_AXIS, _all_gather, _coords, make_mesh, mesh_device

__all__ = ["sharded_graph_search", "sharded_graph_search_core"]


def _replicated_arrays(index: GraphIndex, mesh: DeviceMesh):
    """The index's search arrays on this rank's device; cached per mesh."""
    cache = getattr(index, "_replica_cache", None)
    if cache is not None and cache[0] is mesh:
        return cache[1]
    dev = mesh_device(mesh)
    arrays = tuple(a.to(dev) for a in (index._rows, index._sqn, index.graph, index.sample,
                                       index.entry))
    index._replica_cache = (mesh, arrays)
    return arrays


def sharded_graph_search(
    index: GraphIndex,
    queries,
    k: int = 10,
    *,
    beam: int = 64,
    iters: Optional[int] = None,
    picks_per_iter: int = 8,
    mesh: Optional[DeviceMesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a replicated :class:`GraphIndex` with the query batch split
    over the mesh -> ``(ids [Q, k] i32, squared L2 [Q, k])``, the same on
    every rank; each query's result is its single-device search's."""
    fn, arrays = sharded_graph_search_core(index, int(k), beam=beam, iters=iters,
                                           picks_per_iter=picks_per_iter, mesh=mesh)
    q, _ = as_batch_f32(queries, arrays[0].device)
    if q.shape[1] != index.dim:
        raise DimensionMismatch(expected=index.dim, found=q.shape[1])
    return fn(q, *arrays)


def sharded_graph_search_core(
    index: GraphIndex,
    k: int,
    *,
    beam: int = 64,
    iters: Optional[int] = None,
    picks_per_iter: int = 8,
    mesh: Optional[DeviceMesh] = None,
):
    """:func:`sharded_graph_search` as an ``(fn, arrays)`` pair: ``arrays``
    are the index's arrays on this rank's device (cached per mesh), and
    ``fn(q, *arrays)`` searches this rank's rows of ``q`` and gathers the
    rest; every rank calls it together (``BatchPipeline.from_core`` can
    drive it)."""
    if index.ntotal == 0:
        raise EmptyInput("index is empty")
    if mesh is None:
        mesh = make_mesh()
    arrays = _replicated_arrays(index, mesh)
    di, dn, _, _ = _coords(mesh)
    group = mesh.get_group(DATA_AXIS)
    n, k, beam, picks = index.ntotal, int(k), int(beam), int(picks_per_iter)

    def fn(q, rows, sqn, graph, sample, entry):
        nq = q.shape[0]
        per = -(-nq // dn)
        mine = q[di * per:(di + 1) * per]
        if mine.shape[0] < per:  # zero rows pad the last ranks
            mine = torch.nn.functional.pad(mine, (0, 0, 0, per - mine.shape[0]))
        ids, dist = _run_search(mine, rows, sqn, graph, sample, entry, n, k, beam, iters, picks)
        packed = torch.stack([ids.to(torch.int32), dist.contiguous().view(torch.int32)])
        cat = torch.cat(_all_gather(packed, group), dim=1)[:, :nq]
        return cat[0], cat[1].view(torch.float32)

    return fn, arrays
