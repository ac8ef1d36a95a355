"""Sharded OPQ training — the port of ``vq_tpu.parallel.opq``.

OPQ alternates (rotate -> PQ-train -> encode / decode -> orthogonal
Procrustes), every data-touching step on the row shards:

* rotate: each rank's rows times the replicated ``[d, d]`` rotation;
* PQ train: :func:`~vq_tpu_torch.parallel.sharded_pq_train`'s loop,
  warm-started from the previous round's codebooks (its final inertia
  pass skipped: OPQ keeps only the codebooks);
* encode: :func:`~vq_tpu_torch.parallel.sharded_pq_encode` (K4 a shard);
* Procrustes: each rank's ``x_lᵀ · decode(codes_l)``, summed to
  ``[d, d]`` with ``dist.all_reduce`` on the data axis; one SVD, on rank
  0, whose rotation is broadcast so every rank holds the same bits.

The single-device twin is :func:`vq_tpu_torch.models.opq.opq_train`: the
same alternation and products, so on a world of one with
``overlap=False`` the two agree bit for bit. Across packages OPQ is held
on its objective (R10: the rotations' fp32 products differ in their last
bits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.pq import pq_decode
from vq_tpu_torch.ops.kmeans import CONVERGENCE_EPS
from vq_tpu_torch.parallel.encode import sharded_pq_encode
from vq_tpu_torch.parallel.kmeans import _codebooks, _train_sharded
from vq_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    _row_dtensor,
    _sharded,
    check_rows,
    gather_global,
    make_mesh,
)

__all__ = ["sharded_opq_train"]


def _procrustes_sharded(x_l: torch.Tensor, codes_l: torch.Tensor, cb: torch.Tensor,
                        mesh: DeviceMesh) -> torch.Tensor:
    """``U·Vᵀ`` of ``Σ_ranks x_lᵀ·decode(codes_l)``: the ``[d, d]``
    product summed on the data axis, the SVD on rank 0, broadcast."""
    y = pq_decode(codes_l, cb)
    prod = x_l.T @ y
    dist.all_reduce(prod, group=mesh.get_group(DATA_AXIS))
    if dist.get_rank() == 0:
        u, _, vt = torch.linalg.svd(prod, full_matrices=False)
        rot = u @ vt
    else:
        rot = torch.empty_like(prod)
    dist.broadcast(rot, src=0)
    return rot


def sharded_opq_train(
    data,
    num_subspaces: int,
    num_centroids: int,
    *,
    opq_iters: int = 10,
    pq_iters: int = 4,
    final_pq_iters: int = 10,
    seed: int = 42,
    mesh: Optional[DeviceMesh] = None,
    block_rows: Optional[int] = None,
    overlap: bool = True,
) -> Tuple[DTensor, DTensor]:
    """Learn ``(rotation [d, d], codebooks [m, k, sub])`` over a corpus
    sharded across the mesh, the corpus never gathered: the rotation
    replicated, the codebooks as :func:`sharded_pq_train` returns them.
    ``overlap`` goes to every PQ training step."""
    if mesh is None:
        mesh = make_mesh()
    x, n, d = check_rows(data, mesh)
    m, k = int(num_subspaces), int(num_centroids)
    if m <= 0 or d % m != 0:
        raise InvalidParameter("num_subspaces", f"dimension ({d}) must be divisible by m")
    rot = torch.eye(d, dtype=torch.float32, device=x.device)
    cb = None

    def train(xr_l, iters, init):  # sharded_pq_train without its final inertia pass
        _, (c, _, _, _) = _train_sharded(
            _row_dtensor(xr_l, mesh, n), m, k, int(iters), seed, mesh, CONVERGENCE_EPS, block_rows,
            None, init, overlap, per_lane=False, with_inertia=False)
        return _codebooks(mesh, c, m)

    for _ in range(int(opq_iters)):
        xr_l = x @ rot
        cb = train(xr_l, pq_iters, cb)
        full = gather_global(cb)
        codes = sharded_pq_encode(_row_dtensor(xr_l, mesh, n), full, mesh=mesh)
        rot = _procrustes_sharded(x, codes.to_local(), full, mesh)
    cb = train(x @ rot, final_pq_iters, cb)
    return _sharded(rot, mesh, rot.shape, [Replicate(), Replicate()]), cb
