"""Plain IVF-PQ: Lloyd's k-means for the coarse centres and the PQ
codebooks, coarse assignment, PQ encode and decode, a probed ADC search,
and the numbers that hold an IVF-PQ index's outputs to them.

Imports nothing of the program under test. Its inputs are the rows and
queries the benchmark made and the trainers' starts the benchmark drew.
It follows the program's trainers step by step from those starts
(:func:`step_gap`): over 25 Lloyd iterations rounding alone carries two
sound trainers that start alike apart, so only each step can be held to
Lloyd's. The encode and the search are judged from the program's trained
state once that has been held so (an encode is not continuous in its
codebooks either). It computes in float64; the control runs the same
functions in float32 with TF32 products (``dtype=float32`` under
``torch.backends.cuda.matmul.allow_tf32``). Everything runs in row
blocks.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ``[n, k]`` of rows to centres, in their dtype."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * (x @ c.T) + (c * c).sum(1)[None]).clamp_min_(0.0)


def assign2(x, coarse, dtype=F64, block: int = 65_536):
    """The two nearest centres of each row: ``(first, d1, second, d2)``,
    ties to the lower index."""
    c = coarse.to(dtype)
    out = [[], [], [], []]
    for lo in range(0, x.shape[0], block):
        d = sqdist(x[lo:lo + block].to(dtype), c)
        v, i = torch.topk(d, 2, dim=1, largest=False, sorted=True)
        for lst, t in zip(out, (i[:, 0], v[:, 0], i[:, 1], v[:, 1])):
            lst.append(t)
    return tuple(torch.cat(t) for t in out)


def pq_encode(res: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """PQ codes ``[n, m]`` (int64) of residuals in their dtype: the nearest
    centroid of each subspace, ties to the lower index."""
    m, _, s = codebooks.shape
    cb = codebooks.to(res.dtype)
    return torch.stack([torch.argmin(sqdist(res[:, j * s:(j + 1) * s], cb[j]), dim=1)
                        for j in range(m)], dim=1)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor, dtype=F64) -> torch.Tensor:
    cb = codebooks.to(dtype)
    return torch.cat([cb[j][codes[:, j]] for j in range(cb.shape[0])], dim=1)


class Encoded:
    """The reference's index of rows ``x``: each row's nearest list
    (``lists``) and second-nearest (``alt``), their distances, the row's
    codes in its list, its reconstruction (``recon``, float64) and its
    squared reconstruction error coded in either list (``err``,
    ``alt_err``)."""

    def __init__(self, x, coarse, codebooks, dtype=F64, block: int = 65_536, tie: float = 1e-6):
        self.lists, d1, self.alt, d2 = assign2(x, coarse, dtype, block)
        self.ambiguous = (d2 - d1) <= tie * d2
        c = coarse.to(dtype)
        codes, recon, err, alt_err = [], [], [], []
        for lo in range(0, x.shape[0], block):
            xb = x[lo:lo + block].to(dtype)
            for lst, first in ((self.lists, True), (self.alt, False)):
                cl = c[lst[lo:lo + block]]
                cd = pq_encode(xb - cl, codebooks)
                rec = (cl + pq_decode(cd, codebooks, dtype)).to(F64)
                e = ((xb.to(F64) - rec) ** 2).sum(1)
                if first:
                    codes.append(cd)
                    recon.append(rec)
                    err.append(e)
                else:
                    alt_err.append(e)
        self.codes = torch.cat(codes)
        self.recon = torch.cat(recon)
        self.err = torch.cat(err)
        self.alt_err = torch.cat(alt_err)


def recon_gap(x, recon_prog, ref: Encoded) -> float:
    """The widest gap between the program's squared reconstruction error of
    a row and the reference's, over the median reference error: a row
    coded against a wrong list or with a wrong code reads high. A row whose
    two nearest lists tie may sit in either."""
    e_prog = ((x.to(F64) - recon_prog.to(F64)) ** 2).sum(1)
    gap = (e_prog - ref.err).abs()
    gap = torch.where(ref.ambiguous, torch.minimum(gap, (e_prog - ref.alt_err).abs()), gap)
    return float(gap.max() / ref.err.median().clamp_min(1e-30))


def subvectors(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``[m, k, s]``: for each subspace ``j``, the ``j``-th sub-vectors of
    the rows ``rows[j]`` (``rows [m, k]``) of ``x [n, m*s]``."""
    m = rows.shape[0]
    lanes = torch.arange(m, device=x.device)
    return x.reshape(x.shape[0], m, -1)[rows.to(x.device), lanes[:, None]]


def lloyd_step(x, cb, dtype=F64, block: int = 65_536):
    """One Lloyd step over the ``m`` subspaces of ``x [n, m*s]`` from ``cb
    [m, k, s]`` (a ``[k, d]`` start is one subspace), in ``dtype`` ->
    ``(centroids [m, k, s], empty [m, k] bool)``. Each row's sub-vector
    goes to its nearest centroid, ties to the lower index, and a centroid
    moves to the mean of its rows; one left with none stays where it is
    and is marked empty."""
    cb = cb.to(dtype)
    if cb.ndim == 2:
        cb = cb[None]
    m, k, s = cb.shape
    sums = torch.zeros(m, k, s, dtype=dtype, device=cb.device)
    counts = torch.zeros(m, k, dtype=dtype, device=cb.device)
    for lo in range(0, x.shape[0], block):
        xb = x[lo:lo + block].to(device=cb.device, dtype=dtype)
        for j in range(m):
            xj = xb[:, j * s:(j + 1) * s]
            i = torch.argmin(sqdist(xj, cb[j]), dim=1)
            sums[j].index_add_(0, i, xj)
            counts[j].index_add_(0, i, torch.ones(i.shape[0], dtype=dtype, device=i.device))
    empty = counts == 0
    return torch.where(empty[..., None], cb, sums / counts.clamp_min(1.0)[..., None]), empty


def residuals(x, coarse, dtype=F64, block: int = 65_536) -> torch.Tensor:
    """Each row of ``x`` less its nearest coarse centre, in ``dtype``."""
    c = coarse.to(dtype)
    return torch.cat([x[lo:lo + block].to(dtype) - c[assign2(x[lo:lo + block], c, dtype)[0]]
                      for lo in range(0, x.shape[0], block)])


def subvectors(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``[m, k, s]``: for each subspace ``j``, the ``j``-th sub-vectors of
    the rows ``rows[j]`` (``rows [m, k]``) of ``x [n, m*s]``."""
    m = rows.shape[0]
    lanes = torch.arange(m, device=x.device)
    return x.reshape(x.shape[0], m, -1)[rows.to(x.device), lanes[:, None]]


def train(x, coarse_rows, pq_rows, iters: int, dtype=F64):
    """The IVF-PQ trainer, in ``dtype``: ``iters`` Lloyd steps for the
    coarse centres from the rows ``coarse_rows`` of ``x``, then ``iters``
    for the codebooks on the rows' residuals to the last centres, from the
    residuals' sub-vectors at ``pq_rows [m, k]`` -> ``(coarse path, codebook
    path)``: the start and each step's centroids."""
    coarse = [x[coarse_rows.to(x.device)].to(dtype)]
    for _ in range(int(iters)):
        coarse.append(lloyd_step(x, coarse[-1], dtype)[0][0])
    res = residuals(x, coarse[-1], dtype)
    cb = [subvectors(res, pq_rows)]
    for _ in range(int(iters)):
        cb.append(lloyd_step(res, cb[-1], dtype)[0])
    return coarse, cb


def step_gap(x, path) -> tuple:
    """How far a trainer's steps stray from Lloyd's, in float64: for each
    step of ``path`` (the start and each step's centroids, ``[k, d]`` or
    ``[m, k, s]``), the distance between all the centroids the trainer
    reached and the reference's step from the trainer's previous ones;
    their root mean square over the steps, over the reference's first
    move (from the start) -> ``(gap, empty)``. Centroids that a step
    leaves empty are the trainer's own draw: they are left out and counted
    (``empty``). A trainer that returns its start reads 1."""
    total, empty, scale = 0.0, 0, None
    for before, after in zip(path[:-1], path[1:]):
        new, gone = lloyd_step(x, before)
        if scale is None:
            scale = float((new - before.to(new.device, F64).reshape(new.shape)).norm())
        after = after.to(device=new.device, dtype=F64).reshape(new.shape)
        total += float(torch.where(gone[..., None], 0.0, after - new).norm()) ** 2
        empty += int(gone.sum())
    return (total / (len(path) - 1)) ** 0.5 / max(scale, 1e-300), empty


def probe_lists(q, coarse, nprobe: int, dtype=F64, tie: float = 1e-6):
    """``(sure [Q, nlist] bool, probed [Q, nlist] bool)``: the lists each
    query probes for certain -- nearer than its ``nprobe``-th list by more
    than ``tie`` of that distance -- and the ``nprobe`` nearest."""
    d = sqdist(q.to(dtype), coarse.to(dtype))
    v, order = torch.topk(d, nprobe, dim=1, largest=False, sorted=True)
    probed = torch.zeros_like(d, dtype=torch.bool).scatter_(1, order, True)
    return d < v[:, -1:] * (1.0 - tie), probed


def search(q, ref: Encoded, coarse, nprobe: int, k: int, dtype=F64, block: int = 256):
    """The probed ADC search over the reference's index in ``dtype``:
    ``(ids [Q, k], dists [Q, k])``, ascending."""
    recon = ref.recon.to(dtype)
    ids, dists = [], []
    for lo in range(0, q.shape[0], block):
        qb = q[lo:lo + block].to(dtype)
        _, probed = probe_lists(qb, coarse, nprobe, dtype)
        d = torch.where(probed[:, ref.lists], sqdist(qb, recon), torch.inf)
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids.append(torch.where(torch.isfinite(v), i, -1))
        dists.append(v)
    return torch.cat(ids), torch.cat(dists)


def search_gaps(q, ids, dists, ref: Encoded, coarse, nprobe: int, k: int, stored=None,
                block: int = 256):
    """``(dist_gap, miss_gap, bad_ids)`` of one set of answers ``ids``,
    ``dists`` ``[Q, k]``, against the rows as they are stored: ``stored``
    (the program's reconstruction, which :func:`recon_gap` holds to the
    reference: a row whose encoding ties may be stored either way) or else
    the reference's own.

    ``dist_gap``: the widest gap between a returned distance and the
    squared distance from the query to the stored row. ``miss_gap``: the
    widest amount by which the answers' k-th distance exceeds the k-th
    over the rows that surely lie in probed lists (a row whose two nearest
    lists tie counts only where both are probed), so a search that drops
    candidates reads high. Both over the median reference k-th distance.
    ``bad_ids``: answers outside the index or repeated within a query."""
    rows = ref.recon if stored is None else stored.to(device=ref.recon.device, dtype=F64)
    n = rows.shape[0]
    ids = ids.to(device=rows.device, dtype=torch.int64)
    dists = dists.to(device=rows.device, dtype=F64)
    q = q.to(device=rows.device, dtype=F64)
    dist_gap, miss, kth_ref, bad = [], [], [], 0
    for lo in range(0, q.shape[0], block):
        qb, ib, db = q[lo:lo + block], ids[lo:lo + block], dists[lo:lo + block]
        valid = (ib >= 0) & (ib < n)
        marked = torch.where(valid, ib, -1 - torch.arange(k, device=ib.device)[None])
        srt = torch.sort(marked, 1).values
        bad += int((~valid).sum()) + int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
        true = ((qb[:, None, :] - rows[ib.clamp(0, n - 1)]) ** 2).sum(-1)
        dist_gap.append(torch.where(valid, (db - true).abs(), 0.0).amax(1))
        sure, _ = probe_lists(qb, coarse, nprobe)
        seen = sure[:, ref.lists] & (sure[:, ref.alt] | ~ref.ambiguous[None])
        dall = torch.where(seen, sqdist(qb, rows), torch.inf)
        kth = torch.topk(dall, k, dim=1, largest=False, sorted=True).values[:, -1]
        prog_kth = torch.where(valid[:, -1], db[:, -1], torch.inf)
        miss.append(torch.where(torch.isfinite(kth), prog_kth - kth, 0.0))
        kth_ref.append(kth)
    kth_ref = torch.cat(kth_ref)
    scale = float(kth_ref[torch.isfinite(kth_ref)].median().clamp_min(1e-30))
    return (float(torch.cat(dist_gap).max()) / scale,
            max(float(torch.cat(miss).max()) / scale, 0.0), bad)
