"""Host-stepped Lloyd's k-means: observable, checkpointable, resumable —
the port of ``vq_tpu.ops.kmeans_stepped``.

:func:`vq_tpu_torch.ops.kmeans.lloyd` already drives its loop from the
host. :func:`lloyd_stepped` runs the same iteration (one K2 pass through
:func:`lloyd_accumulate_fused`, then the mean update with empty clusters
reseeded from random rows) and adds what a long run needs:

* **Metrics**: a ``kmeans_iter`` event an iteration to a
  :class:`~vq_tpu_torch.utils.metrics.MetricsLogger` (inertia, cluster
  occupancy, reseed count, largest centroid movement, step wall time),
  with the JAX package's field names.
* **Checkpointing**: a ``kmeans_state`` checkpoint every
  ``checkpoint_every`` iterations, in the JAX package's format, so a run
  resumes from either package's file (``resume_from``).
* **Profiler spans**: each phase is a ``torch.profiler`` span
  (:func:`~vq_tpu_torch.utils.metrics.trace`).

The reseed draws come from one ``torch.Generator`` seeded from ``seed``:
the initial sample, then ``k`` row indices an iteration. A resumed run
replays the draws of the iterations its checkpoint covers, so it ends at
the same centroids, bit for bit, as the run it continues.

The final assignment is K1 (:func:`assign_fused`), the ``int2`` argmin;
the JAX package takes ``jnp.argmin`` there, which lets a NaN score win
(ROADMAP.md, R1).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from vq_tpu_torch.models.base import check_training_matrix
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.cuda_kernels import assign_fused, lloyd_accumulate_fused
from vq_tpu_torch.ops.kmeans import (
    CONVERGENCE_EPS,
    KMeansResult,
    _generator,
    _validate_kmeans_args,
)
from vq_tpu_torch.utils.metrics import MetricsLogger, trace

__all__ = ["lloyd_stepped"]


def _update_step(sums, counts, centroids, data, ridx, eps: float):
    """One centroid update with empty clusters reseeded from ``data[ridx]``
    -> ``(new_centroids, changed, movement [k], empty count)``."""
    nonempty = counts > 0
    means = sums / counts.clamp_min(1.0)[:, None]
    new_c = torch.where(nonempty[:, None], means, data[ridx])
    delta = (new_c - centroids).abs()
    moved = (delta >= eps).any(-1)
    changed = torch.where(nonempty, moved, True).any()
    return new_c, changed, delta.amax(-1), (~nonempty).sum()


def lloyd_stepped(
    data,
    k: int,
    max_iters: int = 10,
    seed: int = 0,
    *,
    eps: float = CONVERGENCE_EPS,
    logger: Optional[MetricsLogger] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume_from: Optional[str] = None,
    device=None,
) -> KMeansResult:
    """Lloyd's k-means with an event and an optional checkpoint an
    iteration, on the data's device.

    Same contract as :func:`vq_tpu_torch.ops.kmeans.lloyd` (initial
    centroids: k distinct random rows), plus:

    * ``logger`` receives one ``kmeans_iter`` event an iteration;
    * ``checkpoint_path``: write a resumable checkpoint every
      ``checkpoint_every`` iterations;
    * ``resume_from``: continue a run from its checkpoint file (written by
      either package).

    One host sync an iteration reads the convergence flag.
    """
    from vq_tpu_torch.utils.serialize import (
        KMeansCheckpoint,
        load_kmeans_state,
        save_kmeans_state,
    )

    data = check_training_matrix(data, device)
    n, d = data.shape
    dev = data.device
    k, max_iters = int(k), int(max_iters)
    _validate_kmeans_args(n, k, max_iters)
    g = _generator(seed, dev)
    init_idx = torch.randperm(n, generator=g, device=dev)[:k]
    start_iter = 0
    if resume_from is not None:
        st = load_kmeans_state(resume_from, dev)
        if tuple(st.centroids.shape) != (k, d):
            raise InvalidParameter(
                "resume_from",
                f"checkpoint centroids {tuple(st.centroids.shape)} != ({k}, {d})",
            )
        centroids = st.centroids
        start_iter = st.iteration
        # Replay the reseed draws of the iterations already run, so the
        # resumed run continues the stream the uninterrupted one would use.
        for _ in range(start_iter):
            torch.randint(0, n, (k,), generator=g, device=dev)
    else:
        centroids = data[init_idx]

    changed = True
    it = start_iter
    while it < max_iters and changed:
        t0 = time.perf_counter()
        ridx = torch.randint(0, n, (k,), generator=g, device=dev)
        with trace("vq_tpu_torch.lloyd.assign_accumulate"):
            sums, counts, inertia = lloyd_accumulate_fused(data, centroids)
        with trace("vq_tpu_torch.lloyd.update"):
            centroids, changed_dev, movement, n_empty = _update_step(
                sums, counts, centroids, data, ridx, float(eps))
        changed = bool(changed_dev)
        it += 1
        if logger is not None:
            logger.log(
                "kmeans_iter",
                iteration=it,
                inertia=float(inertia),
                occupancy_min=int(counts.min()),
                occupancy_max=int(counts.max()),
                empty_reseeded=int(n_empty),
                max_movement=float(movement.max()),
                step_s=round(time.perf_counter() - t0, 6),
            )
        if checkpoint_path is not None and it % max(1, int(checkpoint_every)) == 0:
            save_kmeans_state(checkpoint_path,
                              KMeansCheckpoint(centroids=centroids, iteration=it, seed=int(seed)))

    with trace("vq_tpu_torch.lloyd.final_assign"):
        assignments, sq = assign_fused(data, centroids)
    return KMeansResult(
        centroids, assignments, sq.sum(), torch.tensor(it, dtype=torch.int32, device=dev),
        torch.tensor(not changed, device=dev),
    )
