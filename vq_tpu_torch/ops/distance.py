"""Batched distances — the port of ``vq_tpu.ops.distance`` that the PQ
slice needs: the metric names and the ``[n, d] x [k, d] -> [n, k]``
pairwise functions that exact rerank uses.

The squared-L2 form is ``max(||x||^2 + ||c||^2 - 2 x.c^T, 0)`` with the
product in full f32 (TF32 is off wherever the port runs on the card);
cosine is ``1 - cos`` with the ``1e-10`` zero-norm guard and a [0, 1]
clamp, exactly as in the JAX package.
"""

from __future__ import annotations

import enum

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import as_tensor

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


def pairwise(x, c, metric: Metric | str = Metric.EUCLIDEAN) -> torch.Tensor:
    """All-pairs distances between ``x`` ([n, d] or [d]) and ``c``
    ([k, d] or [d]) -> ``[n, k]`` f32, on ``x``'s device."""
    metric = Metric.parse(metric)
    x = _as_f32_matrix(x, "x")
    c = _as_f32_matrix(c, "c").to(x.device)
    if x.shape[1] != c.shape[1]:
        raise DimensionMismatch(expected=x.shape[1], found=c.shape[1])
    return _PAIRWISE[metric](x, c)
