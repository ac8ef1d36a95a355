"""Readers of the texmex formats of the ANN benchmarks (SIFT-1M, GIST-1M)
— the port's own copy of ``vq_tpu.utils.datasets``, pure numpy.

Every row is a little-endian ``int32`` dimension ``d`` followed by ``d``
values: ``float32`` (``.fvecs``), ``uint8`` (``.bvecs``) or ``int32``
(``.ivecs``, ground-truth neighbour ids). All rows of a file share one
``d``; the readers check that and fail loudly on a truncated or corrupt
file. Reads are bounded by ``max_rows`` and leave the tail of a large
file unread: ``np.fromfile`` with a count, then a strided reinterpret.
Only local files are read; nothing is downloaded.

>>> import os, tempfile
>>> import numpy as np
>>> rows = np.arange(6, dtype=np.float32).reshape(2, 3)
>>> path = os.path.join(tempfile.mkdtemp(), "tiny.fvecs")
>>> np.hstack([np.full((2, 1), 3, np.int32).view(np.float32), rows]).tofile(path)
>>> read_fvecs(path).tolist()
[[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vq_tpu_torch.errors import InvalidData, InvalidParameter

__all__ = ["read_fvecs", "read_bvecs", "read_ivecs", "load_dataset"]


def _read_vecs(
    path: str,
    value_dtype: np.dtype,
    max_rows: Optional[int],
) -> np.ndarray:
    """Shared texmex reader: ``[int32 d][d x value_dtype]`` per row."""
    value_dtype = np.dtype(value_dtype)
    if max_rows is not None and int(max_rows) < 1:
        raise InvalidParameter("max_rows", "must be >= 1")
    size = os.path.getsize(path)
    if size < 4:
        raise InvalidData(f"{path}: too short for a texmex header")
    with open(path, "rb") as f:
        d = int(np.fromfile(f, dtype="<i4", count=1)[0])
        if d <= 0 or 4 + d * value_dtype.itemsize > size:
            raise InvalidData(
                f"{path}: implausible leading dimension {d} for file "
                f"size {size}"
            )
        row_bytes = 4 + d * value_dtype.itemsize
        if size % row_bytes != 0:
            raise InvalidData(
                f"{path}: size {size} is not a multiple of the row "
                f"stride {row_bytes} (d={d}) — truncated or not a "
                f"{value_dtype.name} texmex file"
            )
        n = size // row_bytes
        if max_rows is not None:
            n = min(n, int(max_rows))
        f.seek(0)
        raw = np.fromfile(f, dtype=np.uint8, count=n * row_bytes)
    rows = raw.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view("<i4").reshape(n)
    if not (dims == d).all():
        bad = int(np.argmax(dims != d))
        raise InvalidData(
            f"{path}: row {bad} declares dimension {int(dims[bad])}, "
            f"expected {d}"
        )
    vals = rows[:, 4:].copy().view(value_dtype.newbyteorder("<"))
    return np.ascontiguousarray(vals.astype(value_dtype)).reshape(n, d)


def read_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """Read an ``.fvecs`` file -> ``[n, d] float32`` (SIFT/GIST corpora)."""
    return _read_vecs(path, np.float32, max_rows)


def read_bvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """Read a ``.bvecs`` file -> ``[n, d] uint8`` (SIFT1B-style corpora)."""
    return _read_vecs(path, np.uint8, max_rows)


def read_ivecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """Read an ``.ivecs`` file -> ``[n, d] int32`` (ground-truth ids)."""
    return _read_vecs(path, np.int32, max_rows)


def load_dataset(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """Dispatch on extension; ``.bvecs`` rows are upcast to float32 (the
    standard treatment — SIFT1B codebooks train in float)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".fvecs":
        return read_fvecs(path, max_rows)
    if ext == ".bvecs":
        return read_bvecs(path, max_rows).astype(np.float32)
    if ext == ".ivecs":
        return read_ivecs(path, max_rows)
    raise InvalidParameter(
        "path", f"unknown dataset extension {ext!r} "
        "(expected .fvecs, .bvecs, or .ivecs)"
    )
