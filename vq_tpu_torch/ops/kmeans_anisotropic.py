"""Anisotropic (score-aware) k-means — the port of
``vq_tpu.ops.kmeans_anisotropic``.

For maximum-inner-product search the error that matters is the error in
the score ``q.x``: quantization error parallel to the datapoint moves
every query's score for it. With residual ``r = x - c`` and unit
direction ``x_hat = x / ||x||`` the loss of a point is (Guo et al. 2020,
the ScaNN codebook loss)

    L(x, c) = ||r||^2 + (eta - 1) * (||x|| - c . x_hat)^2

so the assignment score is the plain ``||x||^2 + ||c||^2 - 2 x.c`` plus
one rank-1 term, from one ``[n, k]`` fp32 product; rows with ``||x|| =
0`` fall back to plain L2. The cluster update solves, per cluster,

    (N I + (eta-1) sum x_hat x_hat^T + ridge I) c = sum x + (eta-1) sum ||x|| x_hat

with the sums taken as one-hot fp32 products over row blocks (one fixed
order, so a seeded run is bit-reproducible on the card; no float
atomics) and the ``k`` systems solved as one batched Cholesky
factorization. Empty clusters reseed from random rows.

The JAX package computes all of this with XLA products, not a Pallas
kernel, so the port is plain PyTorch on every device. Its argmin is the
port's ``int2`` rule (:func:`vq_tpu_torch.ops.cuda_kernels.int_argmin`):
a NaN score never wins, where the reference's ``jnp.argmin`` lets it
(``ROADMAP.md``, R1). Seeded runs draw from a ``torch.Generator``, not
threefry, so they agree with the JAX package on the objective.
"""

from __future__ import annotations

from typing import Optional

import torch

from vq_tpu_torch.errors import InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, check_training_matrix
from vq_tpu_torch.ops.cuda_kernels import int_argmin
from vq_tpu_torch.ops.kmeans import KMeansResult, _generator, _validate_kmeans_args

__all__ = ["lloyd_anisotropic", "anisotropic_eta", "anisotropic_assign"]

_SOLVE_ROWS = 1 << 24  # floats of the [B, d*d] outer-product block of a Lloyd update


def anisotropic_eta(threshold: float, dim: int) -> float:
    """Parallel-error weight from ScaNN's score threshold ``T``:
    ``eta = (d - 1) T^2 / (1 - T^2)``, at least 1 (1 = plain L2)."""
    t = float(threshold)
    if not 0.0 <= t < 1.0:
        raise InvalidParameter("threshold", "must be in [0, 1)")
    if t == 0.0:
        return 1.0
    return max(1.0, (int(dim) - 1) * t * t / (1.0 - t * t))


def _f32(v: float) -> float:
    """``v`` rounded to fp32: the JAX package's traced scalars are fp32."""
    return float(torch.tensor(float(v), dtype=torch.float32))


def _eta_minus_one(eta: float) -> float:
    """``eta - 1`` as the JAX package computes it: in fp32."""
    return _f32(_f32(eta) - 1.0)


def _aniso_scores(x, xx, xnorm, centroids, em1: float) -> torch.Tensor:
    """``[n, k]`` anisotropic losses (``em1 = eta - 1``), in the
    reference's operation order."""
    cc = (centroids * centroids).sum(-1)
    xc = x @ centroids.T
    l2 = xx[:, None] + cc[None, :] - 2.0 * xc
    safe = xnorm.clamp_min(1e-20)
    par = xnorm[:, None] - xc / safe[:, None]
    extra = em1 * par * par
    return l2 + torch.where((xnorm > 0)[:, None], extra, 0.0)


def anisotropic_assign(data, centroids, eta: float, *, device=None):
    """Nearest centroid under the anisotropic loss -> ``(codes [n] i32,
    losses [n] f32)`` on the data's device (int2 argmin: NaN never wins)."""
    x = as_tensor(data, device).to(torch.float32)
    c = as_tensor(centroids, x.device).to(torch.float32)
    xx = (x * x).sum(-1)
    loss, codes = int_argmin(_aniso_scores(x, xx, torch.sqrt(xx), c, _eta_minus_one(eta)))
    return codes, loss


def _normal_sums(onehot, xhat, bvec, k: int, d: int):
    """``(A [k, d, d], b [k, d])``: one-hot fp32 products over row blocks
    of at most ``_SOLVE_ROWS`` outer-product floats, added in block order."""
    n = xhat.shape[0]
    rows = max(1, _SOLVE_ROWS // max(d * d, 1))
    A = torch.zeros((k, d * d), dtype=torch.float32, device=xhat.device)
    for b0 in range(0, n, rows):
        h = xhat[b0:b0 + rows]
        A += onehot[b0:b0 + rows].T @ (h[:, :, None] * h[:, None, :]).reshape(h.shape[0], -1)
    return A.reshape(k, d, d), onehot.T @ bvec


def lloyd_anisotropic(
    data,
    k: int,
    max_iters: int = 10,
    seed: int = 0,
    *,
    eta: Optional[float] = None,
    threshold: float = 0.2,
    generator: Optional[torch.Generator] = None,
    ridge: float = 1e-6,
    device=None,
) -> KMeansResult:
    """Score-aware k-means -> :class:`KMeansResult` on the data's device,
    ``inertia`` the summed anisotropic loss.

    ``eta`` weights parallel error; pass it or derive it from a score
    ``threshold`` (:func:`anisotropic_eta`, T = 0.2 by default); ``eta =
    1`` is plain Lloyd's objective. ``generator`` (on the data's device)
    replaces the JAX package's ``key``. Initial centroids are k distinct
    random rows; a run stops once no centroid moved by ``1e-6`` or more."""
    x = check_training_matrix(data, device)
    n, d = x.shape
    dev = x.device
    k = int(k)
    _validate_kmeans_args(n, k, int(max_iters))
    eta = float(anisotropic_eta(threshold, d) if eta is None else eta)
    if eta < 1.0:
        raise InvalidParameter("eta", "must be >= 1 (1 = plain L2)")
    g = generator if generator is not None else _generator(seed, dev)
    em1, ridge = _eta_minus_one(eta), _f32(ridge)
    xx = (x * x).sum(-1)
    xnorm = torch.sqrt(xx)
    xhat = x / xnorm.clamp_min(1e-20)[:, None]  # zero rows -> zero direction
    bvec = x + em1 * xnorm[:, None] * xhat
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    c = x[torch.randperm(n, generator=g, device=dev)[:k]]
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    it, changed = 0, True
    while changed and it < int(max_iters):
        codes = int_argmin(_aniso_scores(x, xx, xnorm, c, em1))[1]
        onehot = torch.nn.functional.one_hot(codes.to(torch.int64), k).to(torch.float32)
        counts = onehot.sum(0)
        A, b = _normal_sums(onehot, xhat, bvec, k, d)
        A = counts[:, None, None] * eye + em1 * A + ridge * eye
        chol, info = torch.linalg.cholesky_ex(A)
        new_c = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
        failed |= (info != 0).any()
        reseed = x[torch.randint(0, n, (k,), generator=g, device=dev)]
        new_c = torch.where((counts > 0)[:, None], new_c, reseed)
        changed = bool(((new_c - c).abs() >= 1e-6).any())  # the one sync an iteration
        c, it = new_c, it + 1
    if bool(failed):
        raise InvalidData("anisotropic k-means: a cluster's normal matrix is not positive "
                          "definite (non-finite training data?)")
    loss, codes = int_argmin(_aniso_scores(x, xx, xnorm, c, em1))
    return KMeansResult(c, codes, loss.sum(), torch.tensor(it, dtype=torch.int32, device=dev),
                        torch.tensor(not changed, device=dev))
