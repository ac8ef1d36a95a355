"""Streaming / mini-batch k-means, for corpora larger than device memory —
the port of ``vq_tpu.ops.kmeans_stream``.

Mini-batch k-means (Sculley 2010, web-scale k-means): each step assigns
one batch and moves only the centroids it touched, by the online mean
(a per-centre rate of ``batch_mass / count_so_far``). The batch's
assignment, per-cluster sums, counts and inertia are exactly K2's
function, so :func:`minibatch_update` is one K2 pass
(:func:`lloyd_accumulate_fused`) and :func:`pq_minibatch_update` one K3
pass over all m subspaces (:func:`pq_lloyd_accumulate_fused`), then the
online-mean step. The batch loop is on the host, so data can stream from
any source.

Splits from the JAX package, which assigns by ``jnp.argmin`` and sums by
a one-hot product at HIGHEST precision: the port's argmin is the ``int2``
rule (a NaN score never wins; ROADMAP.md, R1), and its sums are K2's
segmented order, so the two agree on codes except at float near ties and
on sums at fp32 tolerance. :func:`kmeans_plusplus_init` is numpy, as in
the JAX package, so the same ``np.random.Generator`` gives the same seeds
bit for bit, and :func:`lloyd_minibatch` draws its shuffle from that same
generator.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from vq_tpu_torch.errors import EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, resolve_device
from vq_tpu_torch.ops.cuda_kernels import (
    assign_fused,
    lloyd_accumulate_fused,
    pq_lloyd_accumulate_fused,
)
from vq_tpu_torch.ops.kmeans import KMeansResult

__all__ = [
    "lloyd_minibatch",
    "minibatch_update",
    "pq_minibatch_update",
    "kmeans_plusplus_init",
]


def kmeans_plusplus_init(
    data, k: int, rng: np.random.Generator, sample: int = 100_000
) -> np.ndarray:
    """k-means++ seeding (Arthur & Vassilvitskii 2007) on a subsample, on
    the host -> ``[k, d]`` f32 numpy seeds.

    D²-weighted sequential selection: each next seed is drawn with
    probability proportional to its squared distance to the nearest seed
    so far. Mini-batch k-means has no empty-cluster reseeding, so good
    seeding is what gives every mode a centroid. ``data`` may be a numpy
    array or a tensor: a tensor's subsample is gathered on its device and
    copied to the host once."""
    n = data.shape[0]
    if n > sample:
        data = data[rng.choice(n, size=sample, replace=False)]
        n = sample
    if isinstance(data, torch.Tensor):
        data = data.detach().to(torch.float32).cpu().numpy()
    seeds = np.empty((k, data.shape[1]), dtype=np.float32)
    seeds[0] = data[rng.integers(n)]
    d2 = np.sum((data - seeds[0]) ** 2, axis=1)
    for i in range(1, k):
        total = float(d2.sum())
        if total <= 0:  # all points identical to a seed
            seeds[i:] = data[rng.integers(n, size=k - i)]
            break
        seeds[i] = data[rng.choice(n, p=d2 / total)]
        d2 = np.minimum(d2, np.sum((data - seeds[i]) ** 2, axis=1))
    return seeds


def _online_mean(centroids, counts, sums, mass):
    """The online-mean step: ``c + (batch_mean - c) * mass / new_count``
    for each centre the batch touched -> ``(centroids, counts)``."""
    new_counts = counts + mass
    batch_mean = sums / mass.clamp_min(1.0)[..., None]
    rate = torch.where(new_counts > 0, mass / new_counts.clamp_min(1.0), 0.0)
    return centroids + (batch_mean - centroids) * rate[..., None], new_counts


def minibatch_update(centroids, counts, batch, k: Optional[int] = None):
    """One mini-batch step: assign ``batch`` and move the touched centroids.

    ``centroids``: ``[k, d]``; ``counts``: ``[k]`` f32 running per-centre
    counts; ``batch``: ``[b, d]``, moved to the centroids' device. Returns
    ``(new_centroids, new_counts, batch_inertia)``. The per-centre rate is
    ``m_c / (counts_c + m_c)`` with ``m_c`` the batch mass of centre c, the
    exact online mean. ``k``, when given, must be the centroids' count."""
    c = as_tensor(centroids).to(torch.float32)
    if k is not None and int(k) != c.shape[0]:
        raise InvalidParameter("k", f"expected {c.shape[0]} (the centroids' count), got {k}")
    x = as_tensor(batch, c.device).to(torch.float32)
    sums, mass, inertia = lloyd_accumulate_fused(x, c)
    new_c, new_counts = _online_mean(c, as_tensor(counts, c.device).to(torch.float32), sums, mass)
    return new_c, new_counts, inertia


def _pq_batch_stats(cb: torch.Tensor, x: torch.Tensor):
    """``(sums [m, k, s], mass [m, k], inertia [m])`` of the rows ``x [b,
    m*s]`` against ``cb [m, k, s]``: one K3 pass; subspace i's inertia
    sums ``max(min_score + ||x_i||^2, 0)`` over rows (``||x_i||^2`` added
    from +0.0 in ascending element order)."""
    m, _, s = cb.shape
    sums, mass, _, minval = pq_lloyd_accumulate_fused(x, cb, with_minval=True)
    xs = x.reshape(-1, m, s)
    xx = torch.zeros((xs.shape[0], m), dtype=torch.float32, device=x.device)
    for e in range(s):
        xx = xx + xs[..., e] * xs[..., e]
    return sums, mass, (minval + xx).clamp_min(0.0).sum(0)


def pq_minibatch_update(centroids, counts, batch):
    """One mini-batch step over all PQ subspaces at once.

    ``centroids``: ``[m, k, s]``; ``counts``: ``[m, k]`` running per-centre
    masses; ``batch``: ``[b, m*s]``. Returns ``(new_centroids, new_counts,
    inertia [m])``, :func:`minibatch_update` in every subspace. One K3 pass
    gives the sums and counts; the inertia of subspace i is the sum over
    rows of ``max(min_score + ||x_i||^2, 0)`` (``||x_i||^2`` added from
    +0.0 in ascending element order), from the scan's minimum scores."""
    cb = as_tensor(centroids).to(torch.float32)
    if cb.ndim != 3:
        raise InvalidParameter("centroids", f"must be [m, k, s], got {cb.ndim}-D")
    m, k, s = cb.shape
    x = as_tensor(batch, cb.device).to(torch.float32)
    if x.ndim != 2 or x.shape[1] != m * s:
        raise InvalidParameter("batch", f"expected [b, {m * s}] rows, got {tuple(x.shape)}")
    sums, mass, inertia = _pq_batch_stats(cb, x)
    new_c, new_counts = _online_mean(cb, as_tensor(counts, cb.device).to(torch.float32), sums, mass)
    return new_c, new_counts, inertia


def lloyd_minibatch(
    data: Union[np.ndarray, torch.Tensor, Iterable],
    k: int,
    batch_size: int = 8192,
    epochs: int = 1,
    seed: int = 0,
    *,
    init=None,
    shuffle: bool = True,
    device=None,
) -> KMeansResult:
    """Mini-batch k-means over an array or an iterable of batches ->
    :class:`KMeansResult` on the working device.

    ``data`` may be a ``[n, d]`` numpy array or tensor (cut into
    mini-batches, shuffled each epoch by the numpy generator seeded from
    ``seed``; a tensor's batches are gathered on its device by that
    permutation) or any iterable of ``[b, d]`` batches (streamed;
    ``epochs`` must be 1 and ``init`` given). Array input defaults to
    :func:`kmeans_plusplus_init` seeding. The working device is
    ``device``, else the tensor's, else the card. The final assignment
    and inertia of an array are K1's."""
    k = int(k)
    if k <= 0:
        raise InvalidParameter("k", "must be greater than 0")
    rng = np.random.default_rng(int(seed))
    final_data = None
    if isinstance(data, (np.ndarray, torch.Tensor)):
        host = None if isinstance(data, torch.Tensor) else np.asarray(data, np.float32)
        arr = as_tensor(data if host is None else host, device).to(torch.float32)
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise EmptyInput("training data must not be empty")
        n = arr.shape[0]
        if n < k:
            raise InvalidParameter("k", f"not enough data points ({n}) for {k} clusters")
        if init is None:
            init = kmeans_plusplus_init(arr if host is None else host, k, rng)
        dev = arr.device

        def batches() -> Iterator[torch.Tensor]:
            for _ in range(int(epochs)):
                order = rng.permutation(n) if shuffle else np.arange(n)
                order_t = torch.from_numpy(order).to(dev)
                for lo in range(0, n, int(batch_size)):
                    yield arr[order_t[lo:lo + int(batch_size)]]

        stream = batches()
        final_data = arr
    else:
        if init is None:
            raise InvalidParameter("init", "streamed input requires explicit initial centroids")
        if int(epochs) != 1:
            raise InvalidParameter("epochs", "streamed input supports 1 epoch")
        dev = resolve_device(device, init)
        stream = iter(data)

    centroids = as_tensor(init, dev).to(torch.float32)
    if centroids.shape[0] != k:
        raise InvalidParameter("init", f"expected {k} initial centroids")
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    steps = 0
    inertia = torch.zeros((), dtype=torch.float32, device=dev)
    for batch in stream:
        batch = as_tensor(batch, dev).to(torch.float32)
        if batch.shape[0] == 0:
            continue
        centroids, counts, inertia = minibatch_update(centroids, counts, batch)
        steps += 1
    if steps == 0:
        raise EmptyInput("training stream produced no batches")

    if final_data is not None:
        assignments, sq = assign_fused(final_data, centroids)
        inertia = sq.sum()
    else:
        assignments = torch.zeros((0,), dtype=torch.int32, device=dev)
    return KMeansResult(
        centroids, assignments, inertia, torch.tensor(steps, dtype=torch.int32, device=dev),
        torch.tensor(False, device=dev),
    )
