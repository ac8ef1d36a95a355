"""Sharded encoding — the port of ``vq_tpu.parallel.encode``.

Encode and quantize have no cross-row dependence, so scaling them is pure
data parallelism: each rank encodes its row block with the single-device
path (K4 for PQ) against the replicated quantizer state, and the codes
stay row-sharded. No collective runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from vq_tpu_torch.errors import DimensionMismatch
from vq_tpu_torch.models.pq import pq_encode
from vq_tpu_torch.ops.distance import Metric
from vq_tpu_torch.parallel.mesh import (
    _row_dtensor,
    gather_global,
    local_rows,
    make_mesh,
    mesh_device,
)

__all__ = ["sharded_pq_encode", "sharded_quantize"]


def sharded_pq_encode(
    x,
    codebooks,
    *,
    mesh: Optional[DeviceMesh] = None,
) -> DTensor:
    """PQ-encode a row-sharded corpus -> row-sharded ``[n, m]`` int32
    codes, each rank's block through K4 (the exact f32 encode of
    ``pq_encode``; the JAX package's ``pq_encode_best``). ``x`` may be a
    host array or tensor (each rank keeps its block) or a row-sharded
    DTensor; the codebooks (a tensor, array or DTensor) replicate."""
    if mesh is None:
        mesh = make_mesh()
    cb = gather_global(codebooks)
    cb = torch.as_tensor(cb).to(device=mesh_device(mesh), dtype=torch.float32)
    m, k, s = cb.shape
    if not hasattr(x, "shape"):
        x = np.asarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != m * s:
        raise DimensionMismatch(expected=m * s, found=x.shape[-1])
    local, n = local_rows(x, mesh)
    codes = pq_encode(local, cb, Metric.SQUARED_EUCLIDEAN)
    return _row_dtensor(codes, mesh, n)


def sharded_quantize(quantizer, x, *, mesh: Optional[DeviceMesh] = None) -> DTensor:
    """Run a quantizer's elementwise ``quantize`` (BQ, SQ) over a
    row-sharded corpus: each rank quantizes its block; the result is
    row-sharded the same way."""
    if mesh is None:
        mesh = make_mesh()
    local, n = local_rows(x, mesh)
    return _row_dtensor(quantizer.quantize(local), mesh, n)
