"""Sharded :class:`~vq_tpu_torch.RefineIndex` search — a sharded base and
a replicated refiner; the port of ``vq_tpu.parallel.refine``.

The base serves with its own sharded layout (list-sharded IVF blocks,
row-sharded flat rows, or the replicated graph) and fetches
``ceil(k_factor · k)`` candidates, merged across ranks; the refine codes
are compact (d bytes a row for SQ8, m₂ for a residual PQ, 2d for bf16
rows), so they go whole to every rank's device, with the base's
``_reconstruct_core`` arrays for a residual refiner, and every rank
re-scores the merged candidates. The re-score is
:func:`vq_tpu_torch.refine._build_refine_fn`, the function the
single-device ``_search_core`` runs, so the ranking (R9 included) is the
single-device one.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_batch_f32
from vq_tpu_torch.parallel.flat import _QUANTIZERS, _on
from vq_tpu_torch.parallel.mesh import make_mesh, mesh_device
from vq_tpu_torch.refine import RefineIndex, _build_refine_fn
from vq_tpu_torch.serving import _pool_of

__all__ = ["sharded_refine_search", "sharded_refine_search_core"]


def _base_core(base, fetch: int, mesh: DeviceMesh, **base_params):
    """The base index's sharded ``(fn, arrays)`` core."""
    from vq_tpu_torch.graph import GraphIndex
    from vq_tpu_torch.ivf import IVFPQIndex
    from vq_tpu_torch.ivf_binary import IVFBinaryIndex
    from vq_tpu_torch.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex
    from vq_tpu_torch.parallel.flat import sharded_flat_search_core
    from vq_tpu_torch.parallel.graph import sharded_graph_search_core
    from vq_tpu_torch.parallel.ivf import sharded_ivf_search_core
    from vq_tpu_torch.parallel.ivf_scan import sharded_scan_search_core
    from vq_tpu_torch.search import FlatIndex, PQIndex, RQIndex, SQIndex

    if isinstance(base, IVFPQIndex):
        return sharded_ivf_search_core(base, fetch, mesh=mesh, **base_params)
    if isinstance(base, (IVFFlatIndex, IVFSQIndex, IVFRQIndex, IVFBinaryIndex)):
        return sharded_scan_search_core(base, fetch, mesh=mesh, **base_params)
    if isinstance(base, GraphIndex):
        return sharded_graph_search_core(base, fetch, mesh=mesh, **base_params)
    if isinstance(base, (FlatIndex, PQIndex, RQIndex, SQIndex)):
        if base_params:
            raise InvalidParameter("base_params",
                                   f"flat bases take no search params, got {base_params}")
        return sharded_flat_search_core(base, fetch, mesh=mesh)
    raise InvalidParameter("base", f"{type(base).__name__} has no sharded serving core")


def _device_copy(obj, dev: torch.device):
    """A shallow copy of an index with its quantizers on ``dev`` (what its
    decode and ``_reconstruct_core`` closures read)."""
    out = copy.copy(obj)
    for name in _QUANTIZERS + ("refine_pq",):
        q = getattr(obj, name, None)
        if q is not None:
            setattr(out, name, _on(q, dev))
    return out


def _replicas(ref: RefineIndex, dev: torch.device):
    """``(decode, rec_fn, arrays)``: the refiner's decode and, for a
    residual refiner, the base's reconstruct on ``dev``, with the refine
    codes (and the reconstruct's arrays) copied whole to ``dev``; cached on
    the index per (device, codes build, base pool and its version): the
    index replaces ``_codes`` on every ``add`` / ``remove_ids`` /
    ``merge_from``."""
    _, pool = _pool_of(ref)
    version = None if pool is None else pool.version
    cache = getattr(ref, "_replica_cache", None)
    if (cache is not None and cache[0] == dev and cache[1] is ref._codes and cache[2] is pool
            and cache[3] == version):
        return cache[4]
    decode = _device_copy(ref, dev)._decode
    rec_fn, arrays = None, (ref._codes.to(dev),)
    if ref.residual:
        rec_fn, rec_arrays = _device_copy(ref.base, dev)._reconstruct_core()
        arrays += tuple(a.to(dev) for a in rec_arrays)
    out = (decode, rec_fn, arrays)
    ref._replica_cache = (dev, ref._codes, pool, version, out)
    return out


def sharded_refine_search_core(
    ref: RefineIndex,
    k: int,
    *,
    k_factor: float = 4.0,
    mesh: Optional[DeviceMesh] = None,
    **base_params,
):
    """:meth:`RefineIndex._search_core` over the mesh: the base fetches
    ``ceil(k_factor * k)`` candidates sharded, the replicated refine codes
    re-score them -> ``(fn, arrays)`` on this rank's device, which every
    rank calls together (``BatchPipeline.from_core`` can drive it)."""
    if ref._codes is None:
        raise EmptyInput("index is empty — add() vectors first")
    if ref._codes.shape[0] != ref.base.ntotal:
        raise InvalidData("refine codes out of sync with the base index — add vectors only "
                          "through RefineIndex.add")
    k = int(k)
    if float(k_factor) < 1.0:
        raise InvalidParameter("k_factor", "must be >= 1")
    if mesh is None:
        mesh = make_mesh()
    fetch = max(k, int(math.ceil(float(k_factor) * k)))
    base_fn, base_arrays = _base_core(ref.base, fetch, mesh, **base_params)
    decode, rec_fn, placed = _replicas(ref, mesh_device(mesh))
    fn = _build_refine_fn(base_fn, len(base_arrays), decode, rec_fn, ref.metric, k)
    return fn, tuple(base_arrays) + placed


def sharded_refine_search(
    ref: RefineIndex,
    queries,
    k: int = 10,
    *,
    k_factor: float = 4.0,
    mesh: Optional[DeviceMesh] = None,
    **base_params,
):
    """One call of :func:`sharded_refine_search_core` -> ``(ids, values)``,
    :meth:`RefineIndex.search`'s contract, the same on every rank."""
    if mesh is None:
        mesh = make_mesh()
    q, _ = as_batch_f32(queries, mesh_device(mesh))
    if q.shape[1] != ref.dim:
        raise DimensionMismatch(expected=ref.dim, found=q.shape[1])
    fn, arrays = sharded_refine_search_core(ref, int(k), k_factor=k_factor, mesh=mesh,
                                            **base_params)
    return fn(q, *arrays)
