"""Sharded input — global row-sharded tensors built without gathering
them; the port of ``vq_tpu.parallel.data``.

* :func:`sharded_synthetic_corpus` — a seeded uniform corpus, made block
  by block so the logical corpus depends only on ``(n, d, seed)``: the
  same rows, bit for bit, on any mesh and in either package.
* :func:`sharded_from_callback` — the general form: any row-range loader
  (an mmap slice, a file shard, a database cursor) becomes a row-sharded
  DTensor, each rank loading its own block only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.parallel.mesh import _block, _coords, _row_dtensor, make_mesh, mesh_device

__all__ = ["sharded_synthetic_corpus", "sharded_from_callback"]


def sharded_from_callback(
    n: int,
    d: int,
    load_rows: Callable[[int, int], np.ndarray],
    mesh: Optional[DeviceMesh] = None,
) -> DTensor:
    """An ``[n, d]`` f32 DTensor sharded over the mesh's data axis.

    ``load_rows(start, stop)`` returns host rows ``[start:stop]`` as an
    ``[stop-start, d]`` array; each rank calls it once, for its own block,
    so a process only ever touches its slice of the corpus."""
    if mesh is None:
        mesh = make_mesh()
    di, dn, _, _ = _coords(mesh)
    if n % dn != 0:
        raise InvalidParameter("n", f"({n}) must divide evenly over {dn} data shards")
    start, stop = _block(n, dn, di)
    out = np.asarray(load_rows(start, stop), dtype=np.float32)
    if out.shape != (stop - start, d):
        raise InvalidParameter("load_rows", f"returned {out.shape}, expected {(stop - start, d)}")
    local = torch.from_numpy(np.ascontiguousarray(out)).to(mesh_device(mesh))
    return _row_dtensor(local, mesh, n)


def sharded_synthetic_corpus(
    n: int,
    d: int,
    seed: int = 0,
    mesh: Optional[DeviceMesh] = None,
    chunk_rows: int = 16384,
) -> DTensor:
    """Seeded uniform[0, 1) corpus, made by each rank for its own block.

    Row block ``[r0, r0 + chunk_rows)`` always comes from
    ``numpy.random.default_rng((seed, r0 // chunk_rows))``, as in the JAX
    package, so the corpus depends only on ``(n, d, seed)``."""

    def load_rows(start: int, stop: int) -> np.ndarray:
        out = np.empty((stop - start, d), dtype=np.float32)
        pos = start
        while pos < stop:
            chunk_id = pos // chunk_rows
            c0 = chunk_id * chunk_rows
            c1 = min(c0 + chunk_rows, n)
            chunk = np.random.default_rng((seed, chunk_id)).random((c1 - c0, d), dtype=np.float32)
            take0, take1 = pos - c0, min(stop, c1) - c0
            out[pos - start:pos - start + (take1 - take0)] = chunk[take0:take1]
            pos += take1 - take0
        return out

    return sharded_from_callback(n, d, load_rows, mesh)
