"""Batched distances — the port of ``vq_tpu.ops.distance``: the metric
names, the ``[n, d] x [k, d] -> [n, k]`` pairwise functions, the
single-pair :func:`distance`, the nearest-row assignment :func:`nearest`,
the row-aligned :func:`rowwise` that TSVQ's descent compares, and the
:class:`Distance` object.

The pairwise squared-L2 form is ``max(||x||^2 + ||c||^2 - 2 x.c^T, 0)``
with the product in full f32 (TF32 is off wherever the port runs on the
card); :func:`rowwise` sums ``(x - y)^2`` elementwise instead, as the JAX
package does. Cosine is ``1 - cos`` with the ``1e-10`` zero-norm guard
and a [0, 1] clamp, exactly as in the JAX package.

:func:`nearest` takes the ``int2`` argmin of
:mod:`vq_tpu_torch.ops.cuda_kernels`: the lowest index wins exact ties
and a NaN distance never wins. The JAX package's ``nearest`` uses
``jnp.argmin``, which lets a NaN win (``ROADMAP.md``, R1).
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import as_tensor
from vq_tpu_torch.ops.cuda_kernels import int_argmin

COSINE_NORM_EPS = 1e-10


class Metric(str, enum.Enum):
    """Distance metric identifiers (same strings as ``vq_tpu``)."""

    SQUARED_EUCLIDEAN = "squared_euclidean"
    EUCLIDEAN = "euclidean"
    MANHATTAN = "manhattan"
    COSINE = "cosine"

    @classmethod
    def parse(cls, value: "Metric | str | None") -> "Metric":
        if value is None:
            return cls.EUCLIDEAN
        if isinstance(value, Metric):
            return value
        try:
            return cls(str(value))
        except ValueError:
            valid = ", ".join(m.value for m in cls)
            raise InvalidParameter(
                "metric", f"unknown metric '{value}'; expected one of: {valid}"
            ) from None


def _sqeuclidean_pairwise(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    xx = (x * x).sum(-1, keepdim=True)
    cc = (c * c).sum(-1)
    xc = x @ c.T
    return torch.clamp_min(xx + cc[None, :] - 2.0 * xc, 0.0)


def _euclidean_pairwise(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sqeuclidean_pairwise(x, c))


def _manhattan_pairwise(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (x[:, None, :] - c[None, :, :]).abs().sum(-1)


def _cosine_pairwise(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    dot = x @ c.T
    nx = torch.sqrt((x * x).sum(-1))
    nc = torch.sqrt((c * c).sum(-1))
    sim = dot / torch.clamp_min(nx[:, None] * nc[None, :], COSINE_NORM_EPS)
    dist = torch.clamp(1.0 - sim, 0.0, 1.0)
    degenerate = (nx[:, None] < COSINE_NORM_EPS) | (nc[None, :] < COSINE_NORM_EPS)
    return torch.where(degenerate, torch.ones_like(dist), dist)


_PAIRWISE = {
    Metric.SQUARED_EUCLIDEAN: _sqeuclidean_pairwise,
    Metric.EUCLIDEAN: _euclidean_pairwise,
    Metric.MANHATTAN: _manhattan_pairwise,
    Metric.COSINE: _cosine_pairwise,
}


def _as_f32_matrix(x, name: str) -> torch.Tensor:
    x = as_tensor(x).to(torch.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise InvalidParameter(name, f"must be 1-D or 2-D, got {x.ndim}-D")
    return x


def _matrices(x, c, name_c: str):
    x = _as_f32_matrix(x, "x")
    c = _as_f32_matrix(c, name_c).to(x.device)
    if x.shape[1] != c.shape[1]:
        raise DimensionMismatch(expected=x.shape[1], found=c.shape[1])
    return x, c


def pairwise(x, c, metric: Metric | str = Metric.EUCLIDEAN) -> torch.Tensor:
    """All-pairs distances between ``x`` ([n, d] or [d]) and ``c``
    ([k, d] or [d]) -> ``[n, k]`` f32, on ``x``'s device."""
    metric = Metric.parse(metric)
    return _PAIRWISE[metric](*_matrices(x, c, "c"))


def distance(a, b, metric: Metric | str = Metric.EUCLIDEAN) -> float:
    """Distance between two single vectors ``[d]``, as a float."""
    metric = Metric.parse(metric)
    a = as_tensor(a).to(torch.float32)
    b = as_tensor(b).to(torch.float32)
    if a.ndim != 1 or b.ndim != 1:
        raise InvalidParameter("a/b", "distance() expects 1-D vectors")
    if a.shape[0] != b.shape[0]:
        raise DimensionMismatch(expected=a.shape[0], found=b.shape[0])
    return float(_PAIRWISE[metric](a[None, :], b[None, :].to(a.device))[0, 0])


def nearest(x, c, metric: Metric | str = Metric.SQUARED_EUCLIDEAN
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of (and distance to) the nearest row of ``c`` for every row
    of ``x`` -> ``(codes [n] int32, dists [n] f32)``: the lowest index on
    exact ties, and a NaN distance never wins (``int2``)."""
    metric = Metric.parse(metric)
    dists, codes = int_argmin(_PAIRWISE[metric](*_matrices(x, c, "c")))
    return codes, dists


def _rowwise(x: torch.Tensor, y: torch.Tensor, metric: Metric) -> torch.Tensor:
    if metric in (Metric.SQUARED_EUCLIDEAN, Metric.EUCLIDEAN):
        d = ((x - y) ** 2).sum(-1)
        return torch.sqrt(d) if metric == Metric.EUCLIDEAN else d
    if metric == Metric.MANHATTAN:
        return (x - y).abs().sum(-1)
    dot = (x * y).sum(-1)
    nx = torch.sqrt((x * x).sum(-1))
    ny = torch.sqrt((y * y).sum(-1))
    sim = dot / torch.clamp_min(nx * ny, COSINE_NORM_EPS)
    dist = torch.clamp(1.0 - sim, 0.0, 1.0)
    degenerate = (nx < COSINE_NORM_EPS) | (ny < COSINE_NORM_EPS)
    return torch.where(degenerate, torch.ones_like(dist), dist)


def rowwise(x, y, metric: Metric | str = Metric.EUCLIDEAN) -> torch.Tensor:
    """Row-aligned distances: ``x [n, d]`` against ``y [n, d]`` -> ``[n]``,
    the squared-L2 family as ``sum((x - y)^2)`` elementwise (no expanded
    form)."""
    metric = Metric.parse(metric)
    return _rowwise(*_matrices(x, y, "y"), metric)


class Distance:
    """Distance object with the JAX package's (and pyvq's) surface:
    construct from a metric name or a static factory; ``compute``
    evaluates one pair, ``pairwise`` a batch.

    >>> import numpy as np
    >>> a = np.array([0., 3.], np.float32)
    >>> b = np.array([4., 0.], np.float32)
    >>> Distance.euclidean().compute(a, b)
    5.0
    >>> Distance("manhattan").compute(a, b)
    7.0
    """

    __slots__ = ("metric",)

    def __init__(self, metric: "str | Metric" = Metric.EUCLIDEAN):
        self.metric = Metric.parse(metric)

    @staticmethod
    def euclidean() -> "Distance":
        return Distance(Metric.EUCLIDEAN)

    @staticmethod
    def squared_euclidean() -> "Distance":
        return Distance(Metric.SQUARED_EUCLIDEAN)

    @staticmethod
    def manhattan() -> "Distance":
        return Distance(Metric.MANHATTAN)

    @staticmethod
    def cosine() -> "Distance":
        return Distance(Metric.COSINE)

    @property
    def name(self) -> str:
        return self.metric.value

    def compute(self, a, b) -> float:
        return distance(a, b, self.metric)

    def pairwise(self, x, c) -> torch.Tensor:
        return pairwise(x, c, self.metric)

    def __repr__(self) -> str:
        return f"Distance({self.metric.value!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Distance):
            return self.metric == other.metric
        if isinstance(other, (Metric, str)):
            return self.metric == Metric.parse(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.metric)
