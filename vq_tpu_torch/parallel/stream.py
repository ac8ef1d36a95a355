"""Sharded streaming PQ training: mini-batch updates over a row-sharded
batch — the port of ``vq_tpu.parallel.stream``.

Each rank takes its block of the batch through one K3 pass with the
scan's minimum scores (:func:`pq_lloyd_accumulate_fused`,
``with_minval``), as the single-device
:func:`~vq_tpu_torch.ops.kmeans_stream.pq_minibatch_update` does; the
per-centre ``(sum, mass)`` and the per-subspace inertia are summed with
``dist.all_reduce`` on the data axis (the payload of one Lloyd
iteration), and the exact online-mean step runs on every rank. The
result is ``pq_minibatch_update`` on the whole batch up to f32 summation
order: bit for bit on a world of one with ``overlap=False``; the counts
are whole numbers and equal either way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.kmeans_stream import _online_mean, _pq_batch_stats
from vq_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    _coords,
    _sharded,
    gather_global,
    local_rows,
    make_mesh,
    mesh_device,
    overlapped_sum,
)

__all__ = ["sharded_pq_minibatch_update"]


def sharded_pq_minibatch_update(
    centroids, counts, batch, mesh: Optional[DeviceMesh] = None, overlap: bool = True,
):
    """One streaming mini-batch step with ``batch`` sharded over the mesh.

    ``centroids [m, k, s]`` and ``counts [m, k]`` replicated (tensors,
    arrays or DTensors), ``batch [b, m*s]`` row-sharded or held whole by
    every rank (``b`` must divide over the data axis). Returns replicated
    DTensors ``(centroids', counts', inertia [m])``, the contract of
    ``pq_minibatch_update`` on the whole batch.

    ``overlap`` (the default): where the data axis has more than one rank,
    the rank's rows are swept in two halves and the first half's
    ``all_reduce`` is issued, asynchronously, before the second half's
    kernel (:func:`~vq_tpu_torch.parallel.mesh.overlapped_sum`);
    ``overlap=False`` is one sweep."""
    if mesh is None:
        mesh = make_mesh()
    dev = mesh_device(mesh)
    cb = torch.as_tensor(gather_global(centroids)).to(device=dev, dtype=torch.float32)
    cts = torch.as_tensor(gather_global(counts)).to(device=dev, dtype=torch.float32)
    if cb.ndim != 3:
        raise InvalidParameter("centroids", f"must be [m, k, s], got {cb.ndim}-D")
    m, k, s = cb.shape
    if not hasattr(batch, "shape"):
        batch = np.asarray(batch, np.float32)
    shape = tuple(batch.shape)
    if len(shape) != 2 or shape[0] == 0 or shape[1] != m * s:
        raise InvalidParameter("batch", f"expected non-empty [b, {m * s}] rows, got {shape}")
    _, dn, _, _ = _coords(mesh)
    if shape[0] % dn != 0:
        raise InvalidParameter(
            "batch", f"rows ({shape[0]}) must be divisible by the data-axis size ({dn})")
    xb, _ = local_rows(batch, mesh)
    half = xb.shape[0] // 2 if overlap else 0
    sums, mass, inertia = overlapped_sum(lambda lo, hi: _pq_batch_stats(cb, xb[lo:hi]),
                                         xb.shape[0], half, mesh.get_group(DATA_AXIS))
    new_c, new_counts = _online_mean(cb, cts, sums, mass)
    rep = [Replicate(), Replicate()]
    return tuple(_sharded(t, mesh, t.shape, rep) for t in (new_c, new_counts, inertia))
