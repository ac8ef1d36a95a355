"""Sharded flat search — index rows sharded over the mesh's data axis;
the port of ``vq_tpu.parallel.flat``.

1. **Local scan**: each rank runs its index's own single-device search
   core over its row block (K5 for :class:`PQIndex` and
   :class:`RQIndex`, plain PyTorch for :class:`FlatIndex` and
   :class:`SQIndex`, as in :mod:`vq_tpu_torch.search`), giving a local
   top-k in block coordinates.
2. **Merge**: block ids offset to global ones, one ``dist.all_gather`` of
   every rank's ``[Q, k]`` winners on the data axis (values and ids in
   one int32 buffer), and the port's :func:`_smallest` over the
   concatenation in rank order, so the lowest global id wins ties.

The row layout is the JAX package's (``_shard_layout``): a block is
``ceil(n / D)`` rows rounded up to the scan chunk, the last blocks short
or empty. Each rank copies its own block to its device, as the reference
places one shard a device; the index may stay on the host.
Communication is ``O(D · Q · k)``, independent of the corpus.
The reference merges with ``lax.top_k`` of the negated values, which
lets a NaN with its sign bit set win and ranks -0.0 before +0.0 (R8);
the port's merge ranks every NaN last and ties ±0.0 by id.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import as_batch_f32
from vq_tpu_torch.parallel.mesh import DATA_AXIS, _coords, make_mesh, merge_topk, mesh_device
from vq_tpu_torch.search import FlatIndex, PQIndex, RQIndex, SQIndex

__all__ = ["sharded_flat_search", "sharded_flat_search_core"]

_KINDS = (FlatIndex, PQIndex, RQIndex, SQIndex)
# Each kind's row arrays (the rest of its state replicates) and its
# quantizer, whose tensors every rank holds.
_ROW_ARRAYS = ("_rows", "_row_sqn", "_codes")
_QUANTIZERS = ("pq", "rq", "sq")


def _check_kind(index) -> None:
    if not isinstance(index, _KINDS):
        raise InvalidParameter(
            "index", "sharded_flat_search supports FlatIndex, PQIndex, RQIndex, and SQIndex")


def _shard_layout(n: int, ndev: int, chunk: int) -> Tuple[int, int]:
    """Rows a block and the scan chunk of a row-sharded corpus."""
    shard = -(-n // ndev)
    chunk_eff = min(int(chunk), shard)
    return -(-shard // chunk_eff) * chunk_eff, chunk_eff


def _on(obj, dev: torch.device, skip=()):
    """A shallow copy of ``obj`` with its tensors (but those named in
    ``skip``) and its device on ``dev``."""
    out = copy.copy(obj)
    for name, v in vars(obj).items():
        if name in skip:
            continue
        if isinstance(v, torch.Tensor):
            setattr(out, name, v.to(dev))
        elif isinstance(v, torch.device):
            setattr(out, name, dev)
    return out


def _local_view(index, lo: int, hi: int, dev: torch.device):
    """A shallow copy of ``index`` on ``dev`` that holds a copy of rows
    ``[lo, hi)`` only (whatever device the index lives on: the other
    blocks never reach ``dev``), its quantizer on ``dev``, and no kept
    corpus: rerank stays a single-device step."""
    view = _on(index, dev, skip=_ROW_ARRAYS + ("_corpus",))
    for name in _ROW_ARRAYS:
        a = getattr(index, name, None)
        if a is not None:
            setattr(view, name, a[lo:hi].to(dev, copy=True))
    for name in _QUANTIZERS:
        if hasattr(index, name):
            setattr(view, name, _on(getattr(index, name), dev))
    if hasattr(view, "_corpus"):
        view._corpus = None
    return view


def sharded_flat_search(
    index,
    queries,
    k: int = 10,
    *,
    mesh: Optional[DeviceMesh] = None,
    chunk: int = 262_144,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a flat index with its rows sharded over the mesh ->
    ``(ids [Q, k] int32, values [Q, k])``, the index's own ``search``
    contract (ascending distances, or descending scores for ``dot``; ids
    of -1 pad corpora smaller than k), the same on every rank. Every rank
    calls this with the same index and queries; the index may live on
    the host or on any device, and each rank copies its own row block to
    its device. The query width is checked before any row is placed."""
    _check_kind(index)
    if mesh is None:
        mesh = make_mesh()
    q2d, _ = as_batch_f32(queries, mesh_device(mesh))
    if q2d.shape[1] != index.dim:
        raise DimensionMismatch(expected=index.dim, found=q2d.shape[1])
    fn, arrays = sharded_flat_search_core(index, int(k), mesh=mesh, chunk=chunk)
    return fn(q2d, *arrays)


def sharded_flat_search_core(
    index,
    k: int,
    *,
    mesh: Optional[DeviceMesh] = None,
    chunk: int = 262_144,
):
    """:func:`sharded_flat_search` as an ``(fn, arrays)`` pair, the
    sharded form of the indexes' ``_search_core``: ``arrays`` are this
    rank's row block of the index's search arrays, copied to the rank's
    device (the index may live on the host, and the caller may drop it
    once the core is built: the rank then holds its block only), and ``fn(q,
    *arrays)`` with f32 queries ``q [Q, d]`` on that device runs the
    local scan and the merge; every rank calls it together
    (``BatchPipeline.from_core`` can drive it)."""
    _check_kind(index)
    if mesh is None:
        mesh = make_mesh()
    n = index.ntotal
    if n == 0:
        raise EmptyInput("index is empty — add() vectors first")
    k = min(int(k), n)
    di, dn, _, _ = _coords(mesh)
    if isinstance(index, FlatIndex) and index.metric == "manhattan":
        chunk = min(int(chunk), 8_192)  # a [Q, chunk, d] broadcast a block
    shard_pad, chunk_eff = _shard_layout(n, dn, chunk)
    base = di * shard_pad
    lo, hi = min(base, n), min(base + shard_pad, n)
    view = _local_view(index, lo, hi, mesh_device(mesh))
    dot = getattr(index, "metric", None) == "dot"
    group = mesh.get_group(DATA_AXIS)
    if hi > lo:
        if isinstance(index, PQIndex):
            local_fn, arrays = view._search_core(k)
        else:
            local_fn, arrays = view._search_core(k, chunk=chunk_eff)
    else:
        local_fn, arrays = None, ()

    def fn(q, *arrays):
        nq = q.shape[0]
        vals = torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device)
        ids = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
        if local_fn is not None:
            li, lv = local_fn(q, *arrays)
            kl = li.shape[1]
            vals[:, :kl] = -lv if dot else lv  # smaller is better
            ids[:, :kl] = torch.where(li >= 0, li.to(torch.int32) + base, -1)
        out_ids, best = merge_topk(ids, vals, k, group)
        return out_ids, (-best if dot else best)

    return fn, arrays
