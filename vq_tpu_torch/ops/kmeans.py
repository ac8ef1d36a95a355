"""Lloyd's k-means — the port of ``vq_tpu.ops.kmeans``.

* :func:`assign` — nearest centroid and squared distance, K1
  (:func:`assign_fused`: the kernel on the card, its plain version on
  the CPU).
* :func:`lloyd` — k centroids of ``[n, d]`` data. Each iteration is one
  K2 pass (:func:`lloyd_accumulate_fused`), with sample ``weights`` when
  given (Σ w·x, Σ w), every sum in one fixed order, so a seeded run,
  weighted or not, is bit-reproducible on the card. Then the update: ``mean = sum /
  count``, empty clusters reseeded from random data rows (drawn in
  proportion to the weights when given), ``spherical`` projection, and
  convergence once every non-empty centroid moved less than ``eps``
  elementwise (a reseed counts as a move). One host sync an iteration
  reads that flag. The final assignment and inertia go through K1.
* :func:`kmeans_plusplus_init_device` — D²-weighted seeding on the
  data's device, with no host sync.
* The PQ training loop (:func:`lloyd_batched`): one K3 pass
  (:func:`pq_lloyd_accumulate_fused`) for all m subspaces an iteration,
  with the JAX package's lane freezing: a subspace whose codebook
  stopped moving keeps its codebook, its random stream and its
  iteration count while the others go on.

Randomness comes from ``torch.Generator`` objects seeded from ``seed`` on
the data's device (one per subspace in PQ training). They do not replay
the JAX package's threefry keys, so seeded runs agree with it on quality
(MSE, inertia), and exact comparisons use ``init_centroids`` warm starts.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from vq_tpu_torch.errors import EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, check_training_matrix
from vq_tpu_torch.ops.cuda_kernels import (
    assign_fused,
    lloyd_accumulate_fused,
    pq_lloyd_accumulate_fused,
)

__all__ = [
    "CONVERGENCE_EPS",
    "KMeansResult",
    "assign",
    "default_block_rows",
    "kmeans_plusplus_init_device",
    "lloyd",
    "lloyd_batched",
]

CONVERGENCE_EPS = 1e-6
_KPP_SAMPLE = 100_000  # lloyd's k-means++ candidate pool, as in the JAX package
_SCAN_COLS = 1024  # row width of _cumsum's 2-D scan


class KMeansResult(NamedTuple):
    """Outcome of a Lloyd run (all fields are tensors on the data's device)."""

    centroids: torch.Tensor  # [k, d] f32
    assignments: torch.Tensor  # [n] i32, final nearest centroid of each row
    inertia: torch.Tensor  # [] f32, sum of squared distances (weighted if given)
    iterations: torch.Tensor  # [] i32, Lloyd iterations run
    converged: torch.Tensor  # [] bool, stopped before max_iters


def default_block_rows(n: int, k: int, d: int) -> int:
    """A data-tile height that keeps a ``[block, k]`` score block ~8 MiB."""
    block = max(256, (2 * 1024 * 1024) // max(k, 1))
    block = min(block, n)
    return max(8, (block // 8) * 8)


def _validate_kmeans_args(n: int, k: int, max_iters: int) -> None:
    if k <= 0:
        raise InvalidParameter("k", "must be greater than 0")
    if n < k:
        raise InvalidParameter(
            "k", f"not enough data points ({n}) for {k} clusters"
        )
    if max_iters < 0:
        raise InvalidParameter("max_iters", "must be non-negative")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _lane_generators(seed: int, m: int, device: torch.device) -> List[torch.Generator]:
    return [_generator(int(seed) * 1_000_003 + i, device) for i in range(m)]


# ---------------------------------------------------------------------------
# assign / lloyd / k-means++.
# ---------------------------------------------------------------------------


def assign(data, centroids, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment under squared L2 (the k-means metric,
    whatever the encode-time distance) -> ``(codes [n] i32, sq_dists [n]
    f32)`` on the data's device, through K1. bf16 data stays half in
    device memory; f16 is upcast."""
    x = as_tensor(data, device)
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    return assign_fused(x, as_tensor(centroids, x.device))


def _validate_weights(weights, n: int, device, k: Optional[int] = None):
    """Sample-weight validation -> f32 ``[n]`` tensor (or None)."""
    if weights is None:
        return None
    w = as_tensor(weights, device).to(torch.float32).reshape(-1)
    if w.shape[0] != n:
        raise InvalidParameter("weights", f"expected [{n}], got [{w.shape[0]}]")
    if bool((~torch.isfinite(w)).any() | (w < 0).any()):
        raise InvalidParameter("weights", "must be finite and non-negative")
    if not bool(w.sum() > 0):
        raise InvalidParameter("weights", "must have positive mass")
    if k is not None and int((w > 0).sum()) < k:
        raise InvalidParameter("weights", f"need at least k={k} positive-weight rows")
    return w


def _normalize_rows(c: torch.Tensor) -> torch.Tensor:
    """Rows onto the unit sphere (zero rows pass through)."""
    return c / torch.sqrt((c * c).sum(-1, keepdim=True)).clamp_min(1e-12)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor in one fixed order on every
    device. PyTorch scans a 1-D CUDA tensor with CUB's decoupled look-back,
    whose float sums can round differently from run to run, and a seeded
    draw must not depend on that; rows of a 2-D view are scanned in a
    fixed order each, and their totals carried by this same function."""
    n = x.shape[0]
    if n <= _SCAN_COLS:
        return torch.stack([x, torch.zeros_like(x)]).cumsum(1)[0]
    rows = -(-n // _SCAN_COLS)
    inner = torch.nn.functional.pad(x, (0, rows * _SCAN_COLS - n)).view(rows, -1).cumsum(1)
    totals = inner[:, -1]
    carry = _cumsum(totals) - totals  # exclusive prefix of the row totals
    return (inner + carry[:, None]).reshape(-1)[:n]


def _draw(cw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws: indices of ``u`` (already scaled by the total
    mass) in the cumulative weights ``cw``."""
    return torch.searchsorted(cw, u).clamp(0, cw.shape[0] - 1)


def _kpp_init(data, k: int, g: torch.Generator, sample: int, weights):
    """k-means++ (Arthur & Vassilvitskii 2007) on the device: sequential
    D²-weighted draws by inverse CDF, one ``[n, d]`` matvec a seed, no
    host sync. ``sample`` caps the candidate pool (uniform subsample)."""
    n, d = data.shape
    dev = data.device
    if n > sample:
        idx = torch.randperm(n, generator=g, device=dev)[:sample]
        data = data[idx]
        weights = None if weights is None else weights[idx]
        n = sample
    xx = (data * data).sum(-1)

    def sqdist_to(s):
        return (xx + (s * s).sum() - 2.0 * (data @ s)).clamp_min(0.0)

    if weights is None:
        first = torch.randint(0, n, (1,), generator=g, device=dev)
    else:
        cw = _cumsum(weights)
        first = _draw(cw, torch.rand(1, generator=g, device=dev) * cw[-1])
    seeds = torch.empty((k, d), dtype=torch.float32, device=dev)
    seeds[0] = data.index_select(0, first)[0]
    d2 = sqdist_to(seeds[0])
    u = torch.rand(k, generator=g, device=dev)
    uniform = torch.randint(0, n, (k,), generator=g, device=dev)
    for j in range(1, k):
        mass = d2 if weights is None else d2 * weights
        cm = _cumsum(mass)
        # All D² mass zero (every row equals a seed): a uniform draw.
        idx = torch.where(cm[-1] > 0, _draw(cm, u[j:j + 1] * cm[-1]), uniform[j:j + 1])
        seeds[j] = data.index_select(0, idx)[0]
        d2 = torch.minimum(d2, sqdist_to(seeds[j]))
    return seeds


def kmeans_plusplus_init_device(
    data, k: int, seed: int = 0, *, generator: Optional[torch.Generator] = None,
    sample: int = 100_000, weights=None, device=None,
) -> torch.Tensor:
    """k-means++ seeding on the data's device -> ``[k, d]`` f32 seeds.

    Pass an integer ``seed`` or an explicit ``generator`` (on the data's
    device). ``sample`` caps the candidate pool; with ``weights`` the
    first seed is drawn ∝ w and later ones ∝ w·D²."""
    data = as_tensor(data, device).to(torch.float32)
    n = data.shape[0]
    k = int(k)
    if k <= 0:
        raise InvalidParameter("k", "must be greater than 0")
    if n < k:
        raise InvalidParameter("k", f"not enough data points ({n}) for {k} clusters")
    g = generator if generator is not None else _generator(seed, data.device)
    w = _validate_weights(weights, n, data.device)
    return _kpp_init(data, k, g, int(min(n, max(sample, k))), w)


def lloyd(
    data,
    k: int,
    max_iters: int = 10,
    seed: int = 0,
    *,
    eps: float = CONVERGENCE_EPS,
    init: str = "sample",
    spherical: bool = False,
    init_centroids=None,
    weights=None,
    device=None,
) -> KMeansResult:
    """Train ``k`` centroids of ``data [n, d]`` with Lloyd's algorithm ->
    :class:`KMeansResult` on the data's device.

    ``init``: ``"sample"`` (k distinct random rows; ∝ w by Gumbel top-k
    with ``weights``) or ``"kmeans++"`` (D²-weighted seeding from a
    candidate pool of at most 100k rows). ``init_centroids [k, d]``
    warm-starts instead and overrides ``init``. ``spherical=True``
    projects the centroids onto the unit sphere after every update.
    ``weights [n]`` (non-negative, at least k positive) make the updates
    Σ w·x / Σ w (also where Σ w < 1, unlike the JAX package: R6) and the
    inertia Σ w·d²; assignment is unchanged.

    >>> import numpy as np
    >>> pts = np.array([[0.], [0.1], [10.], [10.1]], np.float32)
    >>> res = lloyd(pts, k=2, max_iters=5, seed=0, device="cpu")
    >>> sorted(round(float(c), 2) for c in res.centroids.ravel())
    [0.05, 10.05]
    """
    data = check_training_matrix(data, device)
    n, d = data.shape
    dev = data.device
    k, max_iters = int(k), int(max_iters)
    _validate_kmeans_args(n, k, max_iters)
    w = _validate_weights(weights, n, dev, k)
    g = _generator(seed, dev)
    if init_centroids is not None:
        c = as_tensor(init_centroids, dev).to(torch.float32)
        if c.ndim != 2 or tuple(c.shape) != (k, d):
            raise InvalidParameter(
                "init_centroids", f"expected [k={k}, d={d}], got {tuple(c.shape)}"
            )
    elif init == "kmeans++":
        c = _kpp_init(data, k, g, min(n, _KPP_SAMPLE), w)
    elif init != "sample":
        raise InvalidParameter("init", f"expected 'sample' or 'kmeans++', got {init!r}")
    elif w is None:
        c = data[torch.randperm(n, generator=g, device=dev)[:k]]
    else:  # k distinct rows ∝ w: Gumbel top-k, zero weights never chosen
        u = torch.rand(n, generator=g, device=dev).clamp_min(1e-12)
        score = torch.log(w) - torch.log(-torch.log(u))
        c = data[torch.sort(score, descending=True, stable=True)[1][:k]]
    if spherical:
        c = _normalize_rows(c)
    cw = None if w is None else _cumsum(w)
    it, changed = 0, True
    while changed and it < max_iters:
        sums, counts, _ = lloyd_accumulate_fused(data, c, w)
        if w is None:
            ridx = torch.randint(0, n, (k,), generator=g, device=dev)
        else:
            ridx = _draw(cw, torch.rand(k, generator=g, device=dev) * cw[-1])
        nonempty = counts > 0
        # Σ w·x / Σ w wherever Σ w > 0: the JAX package divides by max(Σ w, 1),
        # which pulls a cluster whose weights sum below 1 toward the origin
        # (ROADMAP.md, R6). Unweighted counts are whole rows, so unchanged.
        means = sums / torch.where(nonempty, counts, 1.0)[:, None]
        new_c = torch.where(nonempty[:, None], means, data[ridx])
        if spherical:
            new_c = _normalize_rows(new_c)
        moved = ((new_c - c).abs() >= eps).any(-1)
        changed = bool(torch.where(nonempty, moved, True).any())  # the one sync
        c, it = new_c, it + 1
    codes, sq = assign_fused(data, c)
    if w is not None:
        sq = sq * w
    return KMeansResult(
        c, codes, sq.sum(), torch.tensor(it, dtype=torch.int32, device=dev),
        torch.tensor(not changed, device=dev),
    )


# ---------------------------------------------------------------------------
# PQ training (K3).
# ---------------------------------------------------------------------------


def _pq_lloyd_fused(
    x: torch.Tensor,
    k: int,
    m: int,
    max_iters: int,
    eps: float,
    seed: int,
    init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PQ training loop over the interleaved ``x [n, m*s]`` ->
    ``(codebooks [m, k, s], iterations [m] i32, converged [m] bool)``."""
    n, d = x.shape
    s = d // m
    dev = x.device
    xv = x.view(n, m, s)
    lanes = torch.arange(m, device=dev)
    gens = _lane_generators(seed, m, dev)
    if init is not None:
        cb = init.to(device=dev, dtype=torch.float32).clone()
    else:
        idx = torch.stack([
            torch.randperm(n, generator=g, device=dev)[:k] for g in gens
        ])  # [m, k] distinct rows per subspace
        cb = xv[idx, lanes[:, None]]  # [m, k, s]
    it = [0] * m
    changed = [True] * m
    while any(c and i < max_iters for c, i in zip(changed, it)):
        sums, counts, _ = pq_lloyd_accumulate_fused(x, cb)
        nonempty = counts > 0
        means = sums / torch.where(nonempty, counts, 1.0)[..., None]
        ridx = torch.zeros((m, k), dtype=torch.int64, device=dev)
        for i in range(m):
            if changed[i]:  # a frozen lane's stream does not advance
                ridx[i] = torch.randint(0, n, (k,), generator=gens[i], device=dev)
        new_cb = torch.where(nonempty[..., None], means, xv[ridx, lanes[:, None]])
        moved = ((new_cb - cb).abs() >= eps).any(-1)
        lane_changed = torch.where(nonempty, moved, True).any(-1).tolist()
        live = torch.tensor(changed, device=dev)
        cb = torch.where(live[:, None, None], new_cb, cb)
        it = [i + c for i, c in zip(it, changed)]
        changed = [c and lc for c, lc in zip(changed, lane_changed)]
    return (
        cb,
        torch.tensor(it, dtype=torch.int32, device=dev),
        torch.logical_not(torch.tensor(changed, device=dev)),
    )


def lloyd_batched(
    data,
    k: int,
    max_iters: int = 10,
    seed: int = 0,
    *,
    eps: float = CONVERGENCE_EPS,
    init_centroids=None,
    device=None,
):
    """Train independent codebooks for a batch of sub-problems at once.

    ``data`` is ``[m, n, d]``; returns ``(centroids [m, k, d],
    iterations [m], converged [m])``. Pass ``init_centroids [m, k, d]`` to
    warm start instead of seeded sampling.
    """
    data = as_tensor(data, device).to(torch.float32)
    if data.ndim != 3:
        raise InvalidParameter("data", f"expected [m, n, d], got {data.ndim}-D")
    m, n, d = data.shape
    if n == 0 or d == 0 or m == 0:
        raise EmptyInput("training data must not be empty")
    k = int(k)
    _validate_kmeans_args(n, k, int(max_iters))
    init = None
    if init_centroids is not None:
        init = as_tensor(init_centroids, data.device).to(torch.float32)
        if tuple(init.shape) != (m, k, d):
            raise InvalidParameter(
                "init_centroids", f"expected {(m, k, d)}, got {tuple(init.shape)}"
            )
    x = data.permute(1, 0, 2).reshape(n, m * d)
    return _pq_lloyd_fused(x, k, m, int(max_iters), float(eps), int(seed), init)
