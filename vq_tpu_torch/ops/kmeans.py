"""PQ training's Lloyd loop — the part of ``vq_tpu.ops.kmeans`` that the
PQ slice runs.

Each iteration is one K3 pass (:func:`pq_lloyd_accumulate_fused`: the
kernel on the card, its plain version on the CPU) for all m subspaces,
then the update: ``mean = sum / count``, empty clusters reseeded from
random data rows, and convergence once every non-empty centroid moved
less than ``eps`` elementwise (a reseed counts as a move). The JAX
package's ``lax.while_loop`` becomes a Python loop with the same lane
freezing: a subspace whose codebook stopped moving keeps its codebook,
its random stream and its iteration count while the others go on.

Randomness comes from one ``torch.Generator`` per subspace, seeded from
``(seed, subspace)`` on the data's device. It does not replay the JAX
package's threefry keys, so seeded runs agree with it on quality (MSE,
inertia), and exact comparisons use ``init_centroids`` warm starts.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from vq_tpu_torch.errors import EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import as_tensor
from vq_tpu_torch.ops.cuda_kernels import pq_lloyd_accumulate_fused

__all__ = ["CONVERGENCE_EPS", "default_block_rows", "lloyd_batched"]

CONVERGENCE_EPS = 1e-6


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


def _lane_generators(seed: int, m: int, device: torch.device) -> List[torch.Generator]:
    gens = []
    for i in range(m):
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) * 1_000_003 + i) % (1 << 63))
        gens.append(g)
    return gens


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
        means = sums / counts.clamp_min(1.0)[..., None]
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
