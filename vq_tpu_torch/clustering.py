"""High-level k-means trainer — the port of ``vq_tpu.clustering``, the
faiss ``Kmeans`` / ``Clustering`` analog.

:class:`Kmeans` wraps :func:`vq_tpu_torch.ops.kmeans.lloyd` (K2 an
iteration, K1 for the final assignment) with the harness production
clustering needs: seeded restarts keeping the lowest objective
(``nredo``), a training subsample so a large corpus does not pay
full-corpus Lloyd passes (``max_points_per_centroid``), spherical
centroids, sample weights, and an assignment surface (K1).

Every step stays on the data's device. The subsample is
``torch.randperm`` from a generator seeded from ``seed``, and restart
``r`` draws from its own generator, seeded from ``(seed, r)``. Neither
replays the JAX package's threefry keys, so seeded runs agree with it on
the objective; exact comparisons use ``init_centroids`` with
``max_points_per_centroid=0``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, check_training_matrix
from vq_tpu_torch.ops.kmeans import KMeansResult, _generator, assign, lloyd
from vq_tpu_torch.search import FlatIndex
from vq_tpu_torch.utils.serialize import load, save

__all__ = ["Kmeans"]

_SUBSAMPLE_STREAM = 0x5AB5  # the subsample's generator, apart from the restarts'


class Kmeans:
    """Seeded multi-restart k-means with on-device subsampling.

    Mirrors the ``faiss.Kmeans`` surface (``d``, ``k``, ``niter``,
    ``nredo``, ``spherical``, ``seed``, ``max_points_per_centroid``;
    ``train`` / ``assign`` / ``centroids`` / ``obj``). ``nredo`` runs
    independent seeded restarts and keeps the centroids with the lowest
    inertia on the same training set.

    >>> import numpy as np
    >>> pts = np.array([[0.], [0.1], [10.], [10.1]], np.float32)
    >>> km = Kmeans(d=1, k=2, seed=3, device="cpu")
    >>> _ = km.train(pts)
    >>> sorted(round(float(c), 2) for c in km.centroids.ravel())
    [0.05, 10.05]

    ``max_points_per_centroid`` bounds the training set at
    ``k * max_points_per_centroid`` rows (the faiss default is 256): a
    larger input is sampled uniformly without replacement on its device.
    ``0`` disables subsampling. ``device`` is where non-tensor input
    lands (the card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        d: int,
        k: int,
        *,
        niter: int = 25,
        nredo: int = 1,
        seed: int = 0,
        spherical: bool = False,
        init: str = "sample",
        max_points_per_centroid: int = 256,
        device=None,
    ):
        self.d = int(d)
        self.k = int(k)
        if self.d <= 0:
            raise InvalidParameter("d", "dimension must be positive")
        if self.k <= 0:
            raise InvalidParameter("k", "k must be positive")
        if int(niter) < 0:
            raise InvalidParameter("niter", "niter must be >= 0")
        if int(nredo) < 1:
            raise InvalidParameter("nredo", "nredo must be >= 1")
        if int(max_points_per_centroid) < 0:
            raise InvalidParameter("max_points_per_centroid", "must be >= 0 (0 disables)")
        self.niter = int(niter)
        self.nredo = int(nredo)
        self.seed = int(seed)
        self.spherical = bool(spherical)
        self.init = str(init)
        self.max_points_per_centroid = int(max_points_per_centroid)
        self.device = device
        self.centroids: Optional[torch.Tensor] = None  # [k, d] f32
        self.obj: Optional[float] = None  # best final inertia
        self.all_objs: List[float] = []  # per-restart final inertias
        self.result: Optional[KMeansResult] = None  # the best restart's result

    # -- training ------------------------------------------------------------

    def _subsample(self, data: torch.Tensor, weights):
        cap = self.k * self.max_points_per_centroid
        n = data.shape[0]
        if self.max_points_per_centroid == 0 or n <= cap:
            return data, weights
        g = _generator(self.seed * 1_000_003 + _SUBSAMPLE_STREAM, data.device)
        idx = torch.randperm(n, generator=g, device=data.device)[:cap]
        return data[idx], None if weights is None else weights[idx]

    def train(self, data, *, init_centroids=None, weights=None) -> float:
        """Run ``nredo`` seeded restarts; keep the lowest-inertia centroids.

        Returns the best objective (sum of squared distances on the
        training sample, weighted when ``weights`` are given); the
        centroids are in ``self.centroids``. ``init_centroids [k, d]``
        warm-starts a single deterministic run instead of the restarts.
        ``weights [n]`` (non-negative) are per-sample importances, carried
        with their rows into the subsample."""
        data = check_training_matrix(data, self.device)
        if data.shape[1] != self.d:
            raise InvalidParameter("data", f"expected dim {self.d}, got {data.shape[1]}")
        if data.shape[0] < self.k:
            raise InvalidParameter("data", f"need at least k={self.k} rows, got {data.shape[0]}")
        if weights is not None:
            weights = as_tensor(weights, data.device).to(torch.float32).reshape(-1)
            if weights.shape[0] != data.shape[0]:
                raise InvalidParameter(
                    "weights", f"expected [{data.shape[0]}], got [{weights.shape[0]}]")
        sample, weights = self._subsample(data, weights)
        best: Optional[KMeansResult] = None
        self.all_objs = []
        redos = 1 if init_centroids is not None else self.nredo
        for r in range(redos):
            res = lloyd(sample, self.k, max_iters=self.niter, seed=self.seed * 1_000_003 + r,
                        init=self.init, spherical=self.spherical,
                        init_centroids=init_centroids, weights=weights)
            obj = float(res.inertia)
            self.all_objs.append(obj)
            if best is None or obj < float(best.inertia):
                best = res
        self.result = best
        self.centroids = best.centroids
        self.obj = float(best.inertia)
        return self.obj

    # -- inference -----------------------------------------------------------

    def _require_trained(self) -> torch.Tensor:
        if self.centroids is None:
            raise InvalidParameter("centroids", "Kmeans is untrained — call train(data) first")
        return self.centroids

    def assign(self, data) -> Tuple[torch.Tensor, torch.Tensor]:
        """Nearest-centroid assignment (K1): ``(sq_distances [n],
        labels [n])``, squared L2 with the lowest index first on ties."""
        centroids = self._require_trained()
        x = as_tensor(data, centroids.device).to(torch.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise InvalidParameter("data", f"expected [n, {self.d}] queries, got {tuple(x.shape)}")
        if x.shape[0] == 0:
            raise EmptyInput()
        labels, dists = assign(x, centroids)
        return dists, labels

    @property
    def index(self):
        """A :class:`vq_tpu_torch.FlatIndex` over the trained centroids
        (the faiss ``kmeans.index`` surface): ``search(x, k)`` gives
        ``(ids, sq_distances)`` of the k nearest centroids."""
        centroids = self._require_trained()
        idx = FlatIndex(self.d, metric="squared_euclidean", device=centroids.device)
        idx.add(centroids)
        return idx

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> str:
        """Single-file ``kmeans_harness`` ``.npz`` (config and centroids),
        the JAX package's format."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "Kmeans":
        """Load a ``kmeans_harness`` saved by either package onto ``device``."""
        return load(path, device, expect="kmeans_harness")

    def __repr__(self) -> str:
        state = "trained" if self.centroids is not None else "untrained"
        return (
            f"Kmeans(d={self.d}, k={self.k}, niter={self.niter}, "
            f"nredo={self.nredo}, spherical={self.spherical}, {state})"
        )


def _kmeans_state(km: Kmeans):
    """``(config, arrays)`` of a :class:`Kmeans` (the ``kmeans_harness`` layout)."""
    arrays = {} if km.centroids is None else {
        "centroids": km.centroids.detach().cpu().numpy()}
    return {
        "d": km.d, "k": km.k, "niter": km.niter, "nredo": km.nredo, "seed": km.seed,
        "spherical": km.spherical, "init": km.init,
        "max_points_per_centroid": km.max_points_per_centroid,
        "obj": km.obj, "all_objs": km.all_objs,
    }, arrays


def _kmeans_from(config, arrays, device) -> Kmeans:
    km = Kmeans(config["d"], config["k"], niter=config["niter"], nredo=config["nredo"],
                seed=config["seed"], spherical=config["spherical"], init=config["init"],
                max_points_per_centroid=config["max_points_per_centroid"], device=device)
    if "centroids" in arrays:
        km.centroids = torch.as_tensor(np.asarray(arrays["centroids"], np.float32), device=device)
        km.obj = config.get("obj")
        km.all_objs = list(config.get("all_objs") or [])
    return km
