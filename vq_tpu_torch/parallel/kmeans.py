"""Sharded k-means / PQ training — the port of ``vq_tpu.parallel.kmeans``.

Lloyd's k-means over a corpus row-sharded across the mesh's data axis,
codebooks replicated along it, and the per-iteration ``(sum, count,
inertia)`` accumulators summed with ``dist.all_reduce`` on the data
axis's group (the JAX package's ``psum``). The communication an
iteration is codebook-sized, ``m·k·(s+1)`` floats, never the rows.

* **The local accumulate** is the port's kernels on the rank's rows: K3
  (:func:`pq_lloyd_accumulate_fused`) for all of the rank's subspaces at
  once; K2 (:func:`lloyd_accumulate_fused`) a subspace when there are
  sample weights (K3 takes none) and for plain k-means (``m == 1``,
  :func:`sharded_lloyd`), the kernel :func:`~vq_tpu_torch.ops.kmeans.lloyd`
  runs.
* **The overlap** (``overlap=True``, the north star's collective /
  compute overlap): the rows are swept in two halves, and the first
  half's sums go out as an ``all_reduce(..., async_op=True)`` before the
  second half's kernel, which does not depend on it; the wait comes after
  it. ``overlap=False`` is one sweep and one ``all_reduce``, and so is a
  data axis of one rank, where the collective has nothing to hide. The
  halves split where the JAX package's do: ``half = (n_l // 2) //
  block_rows * block_rows`` rows, when that is neither 0 nor all of them.
* **The update** runs on every rank from the same summed accumulators, so
  the codebooks never need a broadcast: mean = sum / count wherever the
  count (Σ w) is positive — the port's R6 rule; the JAX package divides
  by ``max(count, 1)`` (``vq_tpu/parallel/kmeans.py:245``) — empty
  clusters reseeded from global rows, the ``eps`` convergence test, and
  ``lloyd_batched``'s lane freezing.
* **The seeded draws** come from the generators that the single-device
  trainer uses (:func:`~vq_tpu_torch.ops.kmeans.lloyd_batched`, one a
  subspace): every rank draws the same global row ids, the rank that owns
  a row contributes it, and one ``all_gather`` on the data axis assembles
  the ``[m, k, s]`` rows bit for bit. So a seeded run equals
  ``lloyd_batched`` up to f32 summation order on any world, and bit for
  bit on a world of one with ``overlap=False``. The reseed gather runs only
  in iterations that left a cluster empty.
* PQ's m subspaces may be sharded over the mesh's ``"sub"`` axis: a rank
  trains its slice of them, and the inertia is summed over that axis too.

Results are DTensors: codebooks ``[m, k, s]`` (``[k, d]`` from
:func:`sharded_lloyd`), iterations and convergence flags ``[m]``,
replicated along the data axis and sharded along the subspace axis; the
inertia replicated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.cuda_kernels import lloyd_accumulate_fused, pq_lloyd_accumulate_fused
from vq_tpu_torch.ops.kmeans import (
    CONVERGENCE_EPS,
    _lane_generators,
    _validate_kmeans_args,
    default_block_rows,
)
from vq_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SUBSPACE_AXIS,
    _all_gather,
    _block,
    _coords,
    _sharded,
    all_reduce_sum,
    check_rows,
    gather_global,
    local_rows,
    make_mesh,
    overlapped_sum,
)

__all__ = ["ShardedKMeansResult", "sharded_lloyd", "sharded_pq_train"]


class ShardedKMeansResult(NamedTuple):
    centroids: torch.Tensor  # [k, d] (sharded_lloyd) or [m, k, s] (pq), a DTensor
    iterations: torch.Tensor  # [] or [m] int32
    converged: torch.Tensor  # [] or [m] bool
    inertia: torch.Tensor  # [] f32: the global sum of squared assignment distances


def _accumulate(xs: torch.Tensor, cb: torch.Tensor, ws: Optional[torch.Tensor], per_lane: bool):
    """This rank's accumulators over ``xs [n_l, m_l*s]`` -> ``(sums [m_l,
    k, s], counts [m_l, k], inertia [])``: one K3 pass, or one K2 pass a
    subspace (``per_lane``; with the weights ``ws [n_l]`` when given), the
    subspaces' inertias added in lane order."""
    if not per_lane:
        return pq_lloyd_accumulate_fused(xs, cb)
    m, _, s = cb.shape
    xv = xs.view(xs.shape[0], m, s)
    sums, counts, inertia = [], [], None
    for i in range(m):
        si, ci, ii = lloyd_accumulate_fused(xv[:, i], cb[i], ws)
        sums.append(si)
        counts.append(ci)
        inertia = ii if inertia is None else inertia + ii
    return torch.stack(sums), torch.stack(counts), inertia


def global_accumulate(xs: torch.Tensor, ws: Optional[torch.Tensor], cb: torch.Tensor,
                      half: int, per_lane: bool, group):
    """One iteration's ``(sums, counts, inertia)`` over this rank's rows
    ``xs`` (weights ``ws``), summed over the data axis's ``group``: the
    rows in two halves, the first half's sums in flight under the second
    half's kernel, where ``half`` splits them and the group has more than
    one rank (:func:`~vq_tpu_torch.parallel.mesh.overlapped_sum`)."""
    return overlapped_sum(
        lambda lo, hi: _accumulate(xs[lo:hi], cb, None if ws is None else ws[lo:hi], per_lane),
        xs.shape[0], half, group)


def _global_rows(xv, lo: int, n: int, idx: torch.Tensor, lanes: torch.Tensor,
                 group) -> torch.Tensor:
    """Rows ``xv_global[idx[i, j], lanes[i]]`` -> ``[m_l, k, s]``, bit for
    bit: this rank fills the ids in its block ``[lo, lo + n_l)``, and an
    ``all_gather`` on the data axis gives each id its owner's row."""
    n_l = xv.shape[0]
    parts = dist.get_world_size(group)
    mine = (idx >= lo) & (idx < lo + n_l)
    rows = xv[(idx - lo).clamp(0, max(n_l - 1, 0)), lanes[:, None]]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    per = -(-n // parts)
    owner = idx // per
    stacked = torch.stack(_all_gather(rows, group))  # [D, m_l, k, s]
    return stacked[owner, torch.arange(idx.shape[0], device=idx.device)[:, None],
                   torch.arange(idx.shape[1], device=idx.device)[None, :]]


def _loop(xs, ws, n, k, max_iters, eps, seed, mesh, half, per_lane, m, lanes_slice, init,
          with_inertia):
    """``lloyd_batched``'s loop over this rank's lanes ``lanes_slice`` of
    the m subspaces -> local ``(codebooks, iterations, converged,
    inertia)``; the final inertia pass runs only ``with_inertia`` (else
    the inertia is None)."""
    dev = xs.device
    m_l = lanes_slice.stop - lanes_slice.start
    s = xs.shape[1] // m_l
    di, dn, _, sn = _coords(mesh)
    lo, _ = _block(n, dn, di)
    data, sub = mesh.get_group(DATA_AXIS), mesh.get_group(SUBSPACE_AXIS)
    xv = xs.view(xs.shape[0], m_l, s)
    lanes = torch.arange(m_l, device=dev)
    gens = _lane_generators(seed, m, dev)[lanes_slice]
    if init is not None:
        cb = init.to(device=dev, dtype=torch.float32).clone()
    else:
        idx = torch.stack([
            torch.randperm(n, generator=g, device=dev)[:k] for g in gens
        ])  # [m_l, k] distinct global rows a subspace, the same on every rank
        cb = _global_rows(xv, lo, n, idx, lanes, data)
    it = [0] * m_l
    changed = [True] * m_l

    def live() -> bool:
        mine = any(c and i < max_iters for c, i in zip(changed, it))
        if sn == 1:
            return mine
        flag = torch.tensor([float(mine)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=sub)
        return bool(flag.item())

    while live():
        sums, counts, _ = global_accumulate(xs, ws, cb, half, per_lane, data)
        nonempty = counts > 0
        # Σ w·x / Σ w wherever Σ w > 0 (R6); unweighted counts are whole rows.
        means = sums / torch.where(nonempty, counts, 1.0)[..., None]
        ridx = torch.zeros((m_l, k), dtype=torch.int64, device=dev)
        for i in range(m_l):
            if changed[i]:  # a frozen lane's stream does not advance
                ridx[i] = torch.randint(0, n, (k,), generator=gens[i], device=dev)
        moved = ((means - cb).abs() >= eps).any(-1)
        lane_changed = torch.where(nonempty, moved, True).any(-1)
        flags = torch.cat([lane_changed, (~nonempty).any().view(1)]).tolist()
        if flags[-1]:  # every rank of the data axis sees the same counts
            reseeded = _global_rows(xv, lo, n, ridx, lanes, data)
            new_cb = torch.where(nonempty[..., None], means, reseeded)
        else:
            new_cb = means
        live_lanes = torch.tensor(changed, device=dev)
        cb = torch.where(live_lanes[:, None, None], new_cb, cb)
        it = [i + c for i, c in zip(it, changed)]
        changed = [c and bool(lc) for c, lc in zip(changed, flags[:-1])]
    inertia = None
    if with_inertia:
        _, _, inertia = global_accumulate(xs, ws, cb, half, per_lane, data)
        (inertia,), _ = all_reduce_sum([inertia], sub)
    return (cb, torch.tensor(it, dtype=torch.int32, device=dev),
            torch.logical_not(torch.tensor(changed, device=dev)), inertia)


def _validate_weights(weights, mesh, n: int, k: int):
    """The checks of ``ops.kmeans._validate_weights`` on the global
    weights -> this rank's block ``[n_l]`` f32 (or None)."""
    if weights is None:
        return None
    w, nw = local_rows(weights, mesh)
    w = w.reshape(-1)
    if nw != n:
        raise InvalidParameter("weights", f"expected [{n}], got [{nw}]")
    bad = ((~torch.isfinite(w)) | (w < 0)).any().to(torch.float32)
    stats = torch.stack([bad, w.sum(), (w > 0).sum().to(torch.float32)])
    dist.all_reduce(stats, group=mesh.get_group(DATA_AXIS))
    bad, mass, positive = stats.tolist()
    if bad:
        raise InvalidParameter("weights", "must be finite and non-negative")
    if not mass > 0:
        raise InvalidParameter("weights", "must have positive mass")
    if positive < k:
        raise InvalidParameter("weights", f"need at least k={k} positive-weight rows")
    return w


def _train_sharded(data, m: int, k: int, max_iters: int, seed: int, mesh, eps: float,
                   block_rows, weights, init_codebooks, overlap: bool, per_lane: bool,
                   with_inertia: bool = True):
    if mesh is None:
        mesh = make_mesh()
    x, n, dim = check_rows(data, mesh)
    if m <= 0:
        raise InvalidParameter("num_subspaces", "must be greater than 0")
    if dim % m != 0:
        raise InvalidParameter("num_subspaces", f"dimension ({dim}) must be divisible by m")
    _validate_kmeans_args(n, k, int(max_iters))
    di, dn, si, sn = _coords(mesh)
    if n % dn != 0:
        raise InvalidParameter(
            "data", f"corpus rows ({n}) must divide evenly over {dn} data shards (pad the corpus)")
    if m % sn != 0:
        raise InvalidParameter("num_subspaces",
                               f"({m}) must divide evenly over {sn} subspace shards")
    s = dim // m
    m_l = m // sn
    lanes = slice(si * m_l, (si + 1) * m_l)
    ws = _validate_weights(weights, mesh, n, k)
    init = None
    if init_codebooks is not None:
        init = gather_global(init_codebooks)
        init = torch.as_tensor(init).to(device=x.device, dtype=torch.float32)
        if tuple(init.shape) != (m, k, s):
            raise InvalidParameter("init_codebooks",
                                   f"expected [{m}, {k}, {s}], got {tuple(init.shape)}")
        init = init[lanes]
    xs = x[:, lanes.start * s:lanes.stop * s].contiguous()
    n_l = xs.shape[0]
    if block_rows is None:
        block_rows = default_block_rows(max(1, n_l), k, s)
    half = ((n_l // 2) // int(block_rows)) * int(block_rows)
    if not overlap:
        half = 0
    cb, it, conv, inertia = _loop(xs, ws, n, k, int(max_iters), float(eps), int(seed), mesh,
                                  half, per_lane or ws is not None, m, lanes, init, with_inertia)
    return mesh, (cb, it, conv, inertia)


_LANES = [Replicate(), Shard(0)]  # replicated along the data axis, sharded along "sub"


def _codebooks(mesh, cb: torch.Tensor, m: int):
    """This rank's ``[m_l, k, s]`` lanes as the ``[m, k, s]`` DTensor."""
    return _sharded(cb, mesh, (m,) + tuple(cb.shape[1:]), _LANES)


def _result(mesh, cb, it, conv, inertia, m: int) -> ShardedKMeansResult:
    return ShardedKMeansResult(
        _codebooks(mesh, cb, m), _sharded(it, mesh, (m,), _LANES),
        _sharded(conv, mesh, (m,), _LANES),
        _sharded(inertia, mesh, (), [Replicate(), Replicate()]))


def sharded_pq_train(
    data,
    num_subspaces: int,
    num_centroids: int,
    max_iters: int = 10,
    seed: int = 42,
    *,
    mesh: Optional[DeviceMesh] = None,
    eps: float = CONVERGENCE_EPS,
    block_rows: Optional[int] = None,
    weights=None,
    init_codebooks=None,
    overlap: bool = True,
) -> ShardedKMeansResult:
    """Train PQ codebooks over a corpus sharded across the mesh.

    ``data`` is ``[n, d]``: a host array or tensor that every rank holds
    (each keeps its row block), or a row-sharded DTensor
    (:func:`~vq_tpu_torch.parallel.shard_rows`,
    :func:`~vq_tpu_torch.parallel.sharded_from_callback`). Returns
    codebooks ``[m, k, s]`` replicated along the data axis and sharded
    along the subspace axis. Validation matches the JAX package's: n must
    divide over the data shards and m over the subspace shards.
    ``weights [n]`` are per-sample importances, sharded with the rows;
    ``init_codebooks [m, k, s]`` warm-starts the refinement (a tensor,
    array or DTensor). ``overlap`` picks the two-half sweep (the default)
    or the single one.
    """
    m, k = int(num_subspaces), int(num_centroids)
    mesh, (cb, it, conv, inertia) = _train_sharded(
        data, m, k, max_iters, seed, mesh, eps, block_rows, weights, init_codebooks, overlap,
        per_lane=False)
    return _result(mesh, cb, it, conv, inertia, m)


def sharded_lloyd(
    data,
    k: int,
    max_iters: int = 10,
    seed: int = 0,
    *,
    mesh: Optional[DeviceMesh] = None,
    eps: float = CONVERGENCE_EPS,
    block_rows: Optional[int] = None,
    weights=None,
    overlap: bool = True,
) -> ShardedKMeansResult:
    """Plain sharded k-means: the ``m == 1`` case of
    :func:`sharded_pq_train`, swept by K2 (the kernel of
    :func:`~vq_tpu_torch.ops.kmeans.lloyd`). Returns centroids ``[k, d]``,
    replicated. Its draws are lane 0's of ``lloyd_batched``, which are
    ``lloyd(seed=seed * 1_000_003)``'s (one generator, the same init rows
    and reseeds), so unweighted it equals that ``lloyd`` run up to f32
    summation order, and bit for bit on a world of one with
    ``overlap=False`` (its inertia is K2's sum, ``lloyd``'s K1's)."""
    k = int(k)
    mesh, (cb, it, conv, inertia) = _train_sharded(
        data, 1, k, max_iters, seed, mesh, eps, block_rows, weights, None, overlap, per_lane=True)
    rep = [Replicate(), Replicate()]
    return ShardedKMeansResult(
        _sharded(cb[0], mesh, cb.shape[1:], rep), _sharded(it[0], mesh, (), rep),
        _sharded(conv[0], mesh, (), rep), _sharded(inertia, mesh, (), rep))
