"""The hand-written CUDA kernels of the port, each beside its plain
PyTorch version — the port of the Pallas kernels that k-means, PQ
train, encode, flat ADC search and IVF search reach in
``vq_tpu/ops/pallas_kernels.py``:

* K1 :func:`assign_fused` (``csrc/assign.cu``) — nearest centroid and
  its squared distance;
* K2 :func:`lloyd_accumulate_fused` (``csrc/lloyd.cu``) — one Lloyd pass
  (sums, counts, inertia), unweighted or with sample weights;
* K3 :func:`pq_lloyd_accumulate_fused` (``csrc/pq_lloyd.cu``) — one Lloyd
  pass of PQ training for all subspaces;
* K4 :func:`pq_encode_fused` (``csrc/pq_encode.cu``) — PQ encode, exact
  (K4) or with the dot in bf16 (K4-bf16) or split bf16 (K4-bf16x3);
* K5 :func:`adc_scan_topk_fused` (``csrc/adc_topk.cu``) — flat ADC scan
  with a per-tile top-``fetch``;
* K6 :func:`ivf_probe_matvec_fused` (``csrc/ivf_matvec.cu``) — dots with
  the rows of the probed chunks of an IVF-Flat / IVF-SQ index;
* K7 :func:`ivf_probe_adc_fused` (``csrc/ivf_probe.cu``) — ADC sums over
  the probed chunks of an IVF index;
* K8 :func:`adc_lookup_fused` (``csrc/adc_lookup.cu``) — the dense ADC
  table sum ``[Q, n]`` that the chunked PQ / RQ scans and
  ``adc_distances`` take.

Each wrapper keeps the JAX entry's name. A tensor on the CPU goes to the
plain version (``*_plain``), which is the arithmetic the kernel is held
to; a CUDA tensor launches the kernel, and a launch the runtime refuses
raises. Nothing falls back. Each wrapper counts its launches in a plain
int attribute, ``launches``, so a run can show which kernels it went
through; :func:`pq_encode_fused` also counts them a precision in
``launches_by`` (K4, K4-bf16 and K4-bf16x3 are three kernels). The
source notes in ``csrc/`` say what bounds each kernel on the card and
what its design does about it.

The argmin of K1, K2, K3 and K4 is the TPU kernels' ``int2`` rule
(``_int_argmin``): the minimum of an orderable int32 key, then the lowest
index among equal keys. NaN never wins, -0.0 equals +0.0, and exact ties
go to the lowest index. ``torch.argmin`` lets NaN win, so nothing here
uses it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vq_tpu_torch.errors import InvalidParameter

__all__ = [
    "orderable_key",
    "key_to_f32",
    "int_argmin",
    "assign_fused",
    "assign_plain",
    "lloyd_accumulate_fused",
    "lloyd_accumulate_plain",
    "pq_encode_fused",
    "pq_encode_plain",
    "pq_scan_plan",
    "ScanPlan",
    "ENCODE_PRECISIONS",
    "EncodeParity",
    "MIN_MATCH",
    "TIE_RTOL",
    "encode_near_ties",
    "encode_parity",
    "mma_fragments",
    "adc_lookup_fused",
    "adc_lookup_plain",
    "pq_lloyd_accumulate_fused",
    "pq_lloyd_accumulate_plain",
    "adc_scan_topk_fused",
    "adc_scan_topk_plain",
    "adc_tile",
    "ivf_probe_adc_fused",
    "ivf_probe_adc_plain",
    "ivf_probe_matvec_fused",
    "ivf_probe_matvec_plain",
    "ivf_matvec_work_list",
    "ivf_matvec_work_list_plain",
]

_INT_MAX = 0x7FFFFFFF
_INF_KEY = 0x7F800000  # orderable_key(+inf)
TOP_LANES = 128  # candidate lanes per tile, as on the TPU
_SMEM_BYTES = 48 * 1024  # shared memory a block uses without opting in
SMEM_OPTIN = 232_448  # shared memory a block may opt in to on an H100 (227 KB)
_SCAN_ROWS = 128  # rows of a PQ scan tile, and centroids a pass (csrc/pq_encode.cu kBM, kBN)
_SCAN_SLICE = 64  # dimensions of a streamed PQ scan slice (kBK)
_SCAN_BLOCKS = 2 * 132  # resident PQ scan blocks: two waves of one a SM
_TARGET_BLOCKS = 132 * 8  # SMs x resident 256-thread blocks
_LOWP_BLOCKS = 132 * 4  # K4-bf16 / K4-bf16x3 blocks of 4 warps in all, at most
_ADC_MODES = {"sum": 0, "l2": 1, "dot": 2}
_PLAIN_ROWS = 16_384  # row block of the plain K3/K4 ([B, m, k] scores)
_PLAIN_CELLS = 1 << 22  # [B, k] scores per block of the plain K1
_CHUNK_ROWS = 1024  # K2's rows per counting-sort chunk, at least
_CHUNK_CELLS = 1 << 24  # K2's (chunk, cluster) cursors, at most
_INERTIA_THREADS = 1024  # K2's inertia partial sums (csrc/lloyd.cu kScanThreads)
_SEGMENT_ROWS = 32  # K2's rows a segment of a cluster's sum (csrc/lloyd.cu kSegRows)
_K3_TERM_THREADS = 256  # K3's inertia partials a block (csrc/pq_lloyd.cu kTermThreads)
_K3_BLOCK_TERMS = 1024  # K3's inertia terms a block (csrc/pq_lloyd.cu kBlockTerms)
_PROBE_THREADS = 256  # row positions per K7 block step (csrc/ivf_probe.cu)
_K6_SEGMENT = 128  # entries a warp of K6's work-list pass, at least
_K6_TASK = 32  # work entries a task of K6's matvec, at most (csrc/ivf_matvec.cu kTaskEntries)
_K6_TABLE_CELLS = 1 << 21  # K6's (chunk, segment) counts, at most (8 MB)
_PLAIN_CELLS_K6 = 1 << 28  # gathered f32 values per block of the plain K6
_PAYLOAD_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.uint8: 3}
ENCODE_PRECISIONS = ("highest", "bf16_fast", "bf16x3")  # K4, K4-bf16, K4-bf16x3
# The near-tie rule of the tensor-core encodes (K4-bf16, K4-bf16x3, B1
# "default"): a code may differ from the plain version's only where the
# two candidates' float64 scores differ by at most TIE_RTOL of
# max(|score|, 1), and at least MIN_MATCH of the codes are equal.
TIE_RTOL = 1e-5
MIN_MATCH = 0.9999
_LOOKUP_THREADS = 256  # rows per K8 tile (csrc/adc_lookup.cu kLookupThreads)


# ---------------------------------------------------------------------------
# The int2 argmin rule (pallas_kernels.py::_orderable_key / _int_argmin).
# ---------------------------------------------------------------------------


def orderable_key(scores: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> i32 map: integer order equals float order, every
    NaN keys above +inf whatever its sign, and -0.0 shares +0.0's key.

    A NaN with its sign bit set (the CPU's default NaN of ``inf - inf``,
    and torch's CPU cast of any NaN to bf16) keys as the same NaN with
    the sign bit clear, so :func:`key_to_f32` gives back a positive NaN.
    The reference's ``_orderable_key`` keys it below -inf, so there such
    a NaN wins (``ROADMAP.md``, R7)."""
    b = scores.contiguous().view(torch.int32)
    b = torch.where(torch.isnan(scores.contiguous()), b & _INT_MAX, b)
    key = torch.where(b < 0, b ^ _INT_MAX, b)
    return torch.where(key == -1, torch.zeros_like(key), key)


def key_to_f32(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`orderable_key` (an involution)."""
    return torch.where(key < 0, key ^ _INT_MAX, key).contiguous().view(torch.float32)


def int_argmin(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min_score f32, argmin i32)`` over the last axis under int2."""
    key = orderable_key(scores)
    mkey = key.amin(-1, keepdim=True)
    col = torch.arange(key.shape[-1], device=key.device, dtype=torch.int32)
    idx = torch.where(key == mkey, col, _INT_MAX).amin(-1)
    return key_to_f32(mkey[..., 0]), idx.to(torch.int32)


# ---------------------------------------------------------------------------
# Shared plumbing.
# ---------------------------------------------------------------------------


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (all on one card), False for CPU tensors."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise InvalidParameter(
            "device", "all operands must lie on one device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise InvalidParameter("device", f"no kernel or plain version for {dev}")


def _launch(fn, *args) -> None:
    """Call C entry ``fn`` on PyTorch's current stream; raise on a refused
    launch. The kernel runs after this returns: temporaries the wrapper
    drops go back to PyTorch's caching allocator, which hands their memory
    only to work queued later on the same stream, so they stay valid for
    the kernel."""
    from vq_tpu_torch.ops._build import LIBRARY

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(LIBRARY.get(), fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def _check_pq_operands(x: torch.Tensor, codebooks: torch.Tensor):
    if codebooks.ndim != 3:
        raise InvalidParameter(
            "codebooks", f"must be [m, k, sub_dim], got {codebooks.ndim}-D"
        )
    m, k, s = codebooks.shape
    if x.ndim != 2 or x.shape[1] != m * s:
        raise InvalidParameter(
            "x", f"expected [n, {m * s}], got {tuple(x.shape)}"
        )
    return m, k, s


def _dot_plain(xs: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Dots ``[B, m, k]`` of ``xs [B, m, s]`` with ``cb [m, k, s]``, summed
    over ``s`` in ascending order one rounded multiply and add at a
    time — the kernels' exact arithmetic."""
    dot = torch.zeros(
        (xs.shape[0], cb.shape[0], cb.shape[1]), dtype=torch.float32,
        device=xs.device,
    )
    for e in range(cb.shape[2]):
        dot = dot + xs[:, :, e, None] * cb[None, :, :, e]
    return dot


def _scores_plain(xs: torch.Tensor, cb: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """``cc - 2 * dot`` for ``xs [B, m, s]`` against ``cb [m, k, s]``."""
    return cc[None] - 2.0 * _dot_plain(xs, cb)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (to nearest even) and back to f32."""
    return t.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# K1: nearest-centroid assignment (replaces _assign_kernel) and K2: one
# Lloyd pass (replaces _lloyd_acc_kernel).
# ---------------------------------------------------------------------------


def _check_assign(x: torch.Tensor, centroids: torch.Tensor) -> None:
    if centroids.ndim != 2 or centroids.shape[0] == 0:
        raise InvalidParameter(
            "centroids", f"must be a non-empty [k, d] matrix, got {tuple(centroids.shape)}"
        )
    if x.ndim != 2 or x.shape[1] != centroids.shape[1]:
        raise InvalidParameter(
            "data", f"expected [n, {centroids.shape[1]}], got {tuple(x.shape)}"
        )


def assign_plain(x: torch.Tensor, centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 -> ``(codes [n] i32, sq_dists [n] f32)``, with
    the kernel's arithmetic: each dot and ``||x||^2`` summed over ``d`` in
    ascending order one rounded multiply and add at a time, the int2
    argmin of the unclamped ``||c||^2 - 2 x.c``, then ``||x||^2`` added
    and the distance clamped at 0 (NaN passes through)."""
    _check_assign(x, centroids)
    c = centroids.to(torch.float32)
    cc = (c * c).sum(-1)
    n, d = x.shape
    codes = torch.empty((n,), dtype=torch.int32, device=x.device)
    dists = torch.empty((n,), dtype=torch.float32, device=x.device)
    rows = max(1, _PLAIN_CELLS // c.shape[0])
    for b0 in range(0, n, rows):
        xb = x[b0:b0 + rows].to(torch.float32)
        dot = torch.zeros((xb.shape[0], c.shape[0]), dtype=torch.float32, device=x.device)
        xx = torch.zeros((xb.shape[0],), dtype=torch.float32, device=x.device)
        for e in range(d):
            xe = xb[:, e]
            dot = dot + xe[:, None] * c[None, :, e]
            xx = xx + xe * xe
        smin, idx = int_argmin(cc[None] - 2.0 * dot)
        t = smin + xx
        codes[b0:b0 + rows] = idx
        dists[b0:b0 + rows] = torch.where(torch.isnan(t), t, t.clamp_min(0.0))
    return codes, dists


def assign_fused(x: torch.Tensor, centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid under squared L2: ``x [n, d]`` (f32 or bf16; f16 is
    upcast) against ``centroids [k, d]`` -> ``(codes [n] i32, sq_dists
    [n] f32)`` under the int2 rule. Every k and d run in one launch."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    c = centroids.to(torch.float32)
    if not _on_card(x, c):
        return assign_plain(x, c)
    _check_assign(x, c)
    x, c = x.contiguous(), c.contiguous()
    cc = (c * c).sum(-1).contiguous()
    n, d = x.shape
    codes = torch.empty((n,), dtype=torch.int32, device=x.device)
    dists = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return codes, dists
    _launch(
        "vq_assign", x.data_ptr(), int(x.dtype == torch.bfloat16), c.data_ptr(),
        cc.data_ptr(), codes.data_ptr(), dists.data_ptr(), n, c.shape[0], d,
    )
    assign_fused.launches += 1
    return codes, dists


assign_fused.launches = 0


def _check_weights(weights: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    if weights is None:
        return None
    w = weights.to(torch.float32).reshape(-1)
    if w.shape[0] != n:
        raise InvalidParameter("weights", f"expected [{n}], got [{w.shape[0]}]")
    return w


def _k2_inertia(v: torch.Tensor) -> torch.Tensor:
    """``v``'s sum in K2's inertia order: thread t of 1024 sums rows t,
    t + 1024, ... in ascending order, then the halves fold pairwise."""
    n = v.shape[0]
    rows = max(1, -(-n // _INERTIA_THREADS))
    part = torch.nn.functional.pad(v, (0, rows * _INERTIA_THREADS - n)).view(rows, -1)
    acc = torch.zeros(_INERTIA_THREADS, dtype=torch.float32, device=v.device)
    for r in range(rows):
        acc = acc + part[r]
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    return acc[0]


def _segment_sums_plain(x: torch.Tensor, labels: torch.Tensor, k: int,
                        w: Optional[torch.Tensor] = None):
    """``(sums [k, d], counts [k])`` of the rows ``x [N, d]`` f32 by
    ``labels [N]`` in ``[0, k)``, in the segmented order of K2's and K3's
    sums stage (``csrc/lloyd.cu`` ``vq_segment_sums``): each cluster's
    rows, in ascending row order, cut into segments of ``_SEGMENT_ROWS``
    (S) rows; each segment's partial added from +0.0 in ascending row
    order, one rounded add a row; each cluster's partials added to +0.0 in
    ascending segment order. With ``w [N]`` the terms are w·x, each product
    rounded before it is added, and the counts Σ w in the same order;
    without, the counts are the exact row counts. S steps over the
    position in a segment, each adding one row to every segment that has
    one, then one step a segment of the largest cluster, each adding one
    partial to every cluster that still has one (O(N·d + k·S·d) work in
    all)."""
    (n, d), dev = x.shape, x.device
    idx = labels.to(torch.int64)
    rows = torch.sort(idx, stable=True)[1]  # by cluster, ascending rows within each
    totals = torch.bincount(idx, minlength=k)
    ends = torch.cumsum(totals, 0)
    nseg = -(-totals // _SEGMENT_ROWS)
    seg_off = torch.cumsum(nseg, 0) - nseg
    seg_cluster = torch.repeat_interleave(torch.arange(k, device=dev), nseg)
    seg = torch.arange(seg_cluster.shape[0], device=dev) - seg_off[seg_cluster]
    end = ends[seg_cluster]  # one past each segment's cluster's last position
    first = end - totals[seg_cluster] + seg * _SEGMENT_ROWS
    part = torch.zeros((seg_cluster.shape[0], d), dtype=torch.float32, device=dev)
    wpart = torch.zeros((seg_cluster.shape[0],), dtype=torch.float32, device=dev)
    for t in range(_SEGMENT_ROWS if n else 0):
        pos = first + t
        has_row = pos < end
        r = rows[pos.clamp(max=n - 1)]
        term = x[r] if w is None else w[r, None] * x[r]
        part = torch.where(has_row[:, None], part + term, part)
        if w is not None:
            wpart = torch.where(has_row, wpart + w[r], wpart)
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = totals.to(torch.float32) if w is None else torch.zeros((k,), dtype=torch.float32, device=dev)
    order = torch.argsort(nseg, descending=True, stable=True)  # clusters, most segments first
    sizes = nseg[order].tolist()
    live = k  # clusters with a segment at the step: a prefix of ``order``
    for i in range(sizes[0]):
        while sizes[live - 1] <= i:
            live -= 1
        cl = order[:live]
        p = seg_off[cl] + i
        sums[cl] = sums[cl] + part[p]
        if w is not None:
            counts[cl] = counts[cl] + wpart[p]
    return sums, counts


def lloyd_accumulate_plain(x: torch.Tensor, centroids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None):
    """Plain version of K2 -> ``(sums [k, d], counts [k], inertia [])``, in
    the kernel's order: :func:`assign_plain`, then the sums and counts of
    the rows by code in the segmented order (:func:`_segment_sums_plain`;
    with ``weights [n]``, Σ w·x and Σ w; without, exact row counts), and
    the inertia Σ d (Σ w·d) in K2's order (:func:`_k2_inertia`)."""
    codes, dists = assign_plain(x, centroids)
    w = _check_weights(weights, x.shape[0])
    sums, counts = _segment_sums_plain(x.to(torch.float32), codes, centroids.shape[0], w)
    return sums, counts, _k2_inertia(dists if w is None else w * dists)


class _SegmentScratch(NamedTuple):
    """Scratch and launch sizes of the sums stage (``vq_segment_sums``) over
    ``rows`` rows of ``d`` and ``k`` clusters."""

    rows_per_chunk: int
    chunks: int
    max_segs: int
    chunk_counts: torch.Tensor
    totals: torch.Tensor
    offsets: torch.Tensor
    perm: torch.Tensor
    seg_off: torch.Tensor
    pseg_off: torch.Tensor
    seg_cluster: torch.Tensor
    psums: torch.Tensor
    pcounts: Optional[torch.Tensor]

    def pointers(self):
        """Device pointers of chunk_counts .. seg_cluster, in the C order."""
        return tuple(t.data_ptr() for t in (
            self.chunk_counts, self.totals, self.offsets, self.perm, self.seg_off,
            self.pseg_off, self.seg_cluster))


def _segment_scratch(rows: int, k: int, d: int, dev, weighted: bool) -> _SegmentScratch:
    """Sizes: chunks of at least ``_CHUNK_ROWS`` rows with chunks·k at most
    ``_CHUNK_CELLS``; at most rows / S + min(k, rows) segments; at most
    2·rows / S partial rows (segments of clusters of more than S rows)."""
    if rows > _INT_MAX:
        raise InvalidParameter(
            "x", f"{rows} rows to sum do not fit in an int32 row id (at most {_INT_MAX})"
        )
    chunks = max(1, min(-(-rows // _CHUNK_ROWS), _CHUNK_CELLS // k))
    per = -(-rows // chunks)
    chunks = -(-rows // per)
    max_segs = rows // _SEGMENT_ROWS + min(k, rows)  # sum of ceil(total / S)
    max_parts = max(1, 2 * rows // _SEGMENT_ROWS)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return _SegmentScratch(
        per, chunks, max_segs, torch.empty((chunks, k), **i32), torch.empty((k,), **i32),
        torch.empty((k,), **i32), torch.empty((rows,), **i32), torch.empty((k + 1,), **i32),
        torch.empty((k,), **i32), torch.empty((max_segs,), **i32),
        torch.empty((max_parts, d), **f32),
        torch.empty((max_parts,), **f32) if weighted else None)


def lloyd_accumulate_fused(x: torch.Tensor, centroids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None):
    """One Lloyd pass over ``x [n, d]`` f32 against ``centroids [k, d]`` ->
    ``(sums [k, d], counts [k], inertia [])``, f32. ``weights [n]`` f32
    (optional) make them Σ w·x, Σ w and Σ w·d.

    On the card the result is bit-identical from run to run and to the
    plain version, weighted or not: both sum in the segmented order
    (``csrc/lloyd.cu``)."""
    x = x.to(torch.float32)
    c = centroids.to(torch.float32)
    w = _check_weights(weights, x.shape[0])
    if not _on_card(x, c, *(() if w is None else (w,))):
        return lloyd_accumulate_plain(x, c, w)
    _check_assign(x, c)
    x, c = x.contiguous(), c.contiguous()
    w = None if w is None else w.contiguous()
    (n, d), k, dev = x.shape, c.shape[0], x.device
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    inertia = torch.empty((), dtype=torch.float32, device=dev)
    if n == 0:
        return sums.zero_(), counts.zero_(), inertia.zero_()
    cc = (c * c).sum(-1).contiguous()
    sc = _segment_scratch(n, k, d, dev, w is not None)
    codes = torch.empty((n,), dtype=torch.int32, device=dev)
    dists = torch.empty((n,), dtype=torch.float32, device=dev)
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    _launch(
        "vq_lloyd", x.data_ptr(), None if w is None else w.data_ptr(), c.data_ptr(),
        cc.data_ptr(), codes.data_ptr(), dists.data_ptr(), *sc.pointers(), sc.psums.data_ptr(),
        None if sc.pcounts is None else sc.pcounts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        inertia.data_ptr(), n, k, d, sc.rows_per_chunk, sc.chunks, sc.max_segs, int(vec),
    )
    lloyd_accumulate_fused.launches += 1
    return sums, counts, inertia


lloyd_accumulate_fused.launches = 0


# ---------------------------------------------------------------------------
# K4: PQ encode (replaces pallas_kernels.py::_pq_encode_kernel), and its
# lower-precision bodies K4-bf16 (_pq_encode_bf16_kernel) and K4-bf16x3
# (_pq_encode_bf16x3_kernel).
# ---------------------------------------------------------------------------


def _check_precision(precision: str) -> None:
    if precision not in ENCODE_PRECISIONS:
        raise InvalidParameter(
            "precision", f"must be one of {list(ENCODE_PRECISIONS)}, got {precision!r}"
        )


def _split_codebooks(cb: torch.Tensor):
    """``(cbh, cbl)``: the bf16 high half of each f32 codebook value and
    the bf16 of its remainder, both as f32 (the TPU caller's split)."""
    cbh = _bf16(cb)
    return cbh, _bf16(cb - cbh)


class ScanPlan(NamedTuple):
    """Launch plan of the PQ scan of K3 and K4 (``csrc/pq_encode.cu``)."""

    resident: bool  # the subspace's codebook stays in shared memory
    stages: int  # depth of the cp.async ring
    smem: int  # dynamic shared-memory bytes a block
    centroids: int  # centroids of a subspace in shared memory at a time
    rows_per_block: int  # rows a (row range, subspace) block scans


def _resident_bytes(k: int, s: int, stages: int) -> int:
    """Shared memory of the resident scan: the codebook padded to whole
    128-centroid passes, its norms and ``stages`` 128-row x tiles, all
    ``s`` rounded up to 4."""
    kp, s4 = -(-k // _SCAN_ROWS) * _SCAN_ROWS, -(-s // 4) * 4
    return 4 * (kp * s4 + kp + stages * _SCAN_ROWS * s4)


def pq_scan_plan(n: int, m: int, k: int, s: int) -> ScanPlan:
    """How the PQ scan runs ``n`` rows against ``m`` subspaces of ``k``
    centroids of width ``s``: with the codebook resident beside a 3-stage
    ring of x tiles (2 stages where 3 do not fit) in blocks of whole
    128-row tiles, two waves of blocks over the card; or, where even 2
    do not fit in ``SMEM_OPTIN``, one block a 128-row tile with the
    codebook streaming past in [128 x 64] slices (3 stages)."""
    for stages in (3, 2):
        smem = _resident_bytes(k, s, stages)
        if smem <= SMEM_OPTIN:
            tiles = -(-n // _SCAN_ROWS)
            chunks = max(1, min(tiles, -(-_SCAN_BLOCKS // max(m, 1))))
            rows = -(-tiles // chunks) * _SCAN_ROWS
            return ScanPlan(True, stages, smem, -(-k // _SCAN_ROWS) * _SCAN_ROWS, rows)
    smem = 4 * 3 * 2 * _SCAN_ROWS * _SCAN_SLICE
    return ScanPlan(False, 3, smem, _SCAN_ROWS, _SCAN_ROWS)


def pq_encode_plain(x: torch.Tensor, codebooks: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """Plain version of K4 / K4-bf16 / K4-bf16x3: ``x [n, m*s]`` -> codes
    ``[n, m]`` i32, the int2 argmin of ``cc - 2 * dot`` with ``cc`` from
    the f32 codebooks and ``dot`` at ``precision``: exact f32
    (``"highest"``); operands rounded to bf16 (``"bf16_fast"``); or
    ``(xh.ch + xh.cl) + xl.ch`` over the bf16 hi/lo split of both
    operands (``"bf16x3"``), each dot summed in ascending order."""
    _check_precision(precision)
    m, k, s = _check_pq_operands(x, codebooks)
    cb = codebooks.to(torch.float32)
    cc = (cb * cb).sum(-1)
    if precision == "bf16_fast":
        cb = _bf16(cb)
    elif precision == "bf16x3":
        cbh, cbl = _split_codebooks(cb)
    out = torch.empty((x.shape[0], m), dtype=torch.int32, device=x.device)
    for b0 in range(0, x.shape[0], _PLAIN_ROWS):
        xs = x[b0:b0 + _PLAIN_ROWS].to(torch.float32).reshape(-1, m, s)
        if precision == "bf16x3":
            xh = _bf16(xs)
            xl = _bf16(xs - xh)
            dot = (_dot_plain(xh, cbh) + _dot_plain(xh, cbl)) + _dot_plain(xl, cbh)
            scores = cc[None] - 2.0 * dot
        else:
            scores = _scores_plain(_bf16(xs) if precision == "bf16_fast" else xs, cb, cc)
        out[b0:b0 + _PLAIN_ROWS] = int_argmin(scores)[1]
    return out


class EncodeParity(NamedTuple):
    """An encode's codes against the plain version's: ``ok`` under the
    precision's rule, the share equal, the count that differ and their
    largest float64 score gap."""

    ok: bool
    match: float
    flips: int
    max_gap: float


def _scores64(xs: torch.Tensor, cs: torch.Tensor, precision: str) -> torch.Tensor:
    """Float64 scores ``||c||^2 - 2 dot`` of rows ``xs [F, s]`` against
    centroids ``cs [F, s]`` (both f32), ``dot`` on the operands that
    ``precision`` rounds (``||c||^2`` from the f32 centroid)."""
    cd = cs.double()
    if precision == "highest":
        parts = [(xs, cs)]
    elif precision == "bf16_fast":
        parts = [(_bf16(xs), _bf16(cs))]
    else:
        xh, ch = _bf16(xs), _bf16(cs)
        parts = [(xh, ch), (xh, _bf16(cs - ch)), (_bf16(xs - xh), ch)]
    dot = sum((a.double() * b.double()).sum(-1) for a, b in parts)
    return (cd * cd).sum(-1) - 2.0 * dot


def encode_near_ties(x: torch.Tensor, codebooks: torch.Tensor, got: torch.Tensor,
                     want: torch.Tensor, precision: str) -> Tuple[int, float, bool]:
    """``(flips, max_gap, all_ties)`` of two code arrays ``[n, m]`` of
    ``x [n, m*s]`` against ``codebooks [m, k, s]``: the (row, subspace)
    pairs where they differ, the largest float64 gap between their two
    candidates' scores (:func:`_scores64` at ``precision``), and whether
    every gap is a near tie, at most ``TIE_RTOL`` of ``max(|score|, 1)``
    (the score of ``want``'s candidate)."""
    _check_precision(precision)
    m, k, s = _check_pq_operands(x, codebooks)
    rows, subs = torch.nonzero(got != want, as_tuple=True)
    if rows.numel() == 0:
        return 0, 0.0, True
    cb = codebooks.to(torch.float32)
    xs = x[rows].to(torch.float32).reshape(-1, m, s)[torch.arange(rows.numel()), subs]
    sg = _scores64(xs, cb[subs, got[rows, subs].long()], precision)
    sw = _scores64(xs, cb[subs, want[rows, subs].long()], precision)
    gap = (sg - sw).abs()
    ties = gap <= TIE_RTOL * sw.abs().clamp_min(1.0)
    return rows.numel(), float(gap.max()), bool(ties.all())


def encode_parity(x: torch.Tensor, codebooks: torch.Tensor, got: torch.Tensor,
                  precision: str, want: Optional[torch.Tensor] = None) -> EncodeParity:
    """The codes ``got`` of ``x`` at ``precision`` against ``want`` (by
    default :func:`pq_encode_plain`'s) under the precision's rule: equal
    for ``"highest"`` (K4 repeats the plain arithmetic); for
    ``"bf16_fast"`` and ``"bf16x3"`` (the tensor cores sum a tile's
    products in their own order) at least ``MIN_MATCH`` equal and every
    difference a float64 near tie (:func:`encode_near_ties`)."""
    if want is None:
        want = pq_encode_plain(x, codebooks, precision)
    match = float((got == want).float().mean()) if got.numel() else 1.0
    flips, gap, ties = encode_near_ties(x, codebooks, got, want, precision)
    ok = flips == 0 if precision == "highest" else match >= MIN_MATCH and ties
    return EncodeParity(ok, match, flips, gap)


def mma_fragments(codebooks: torch.Tensor, precision: str) -> torch.Tensor:
    """The bf16 codebook as K4-bf16 / K4-bf16x3 read it: ``[m, ceil(k / 8),
    ceil(s / 16), 32, 4 P]`` bf16, zero-padded to whole tiles of 8
    centroids and 16 e, each lane's B operand of an ``mma.sync`` m16n8k16
    in turn: lane ``4 g + t`` of n8 tile ``j`` and k-step ``q`` holds
    centroid ``8 j + g`` at e = ``16 q + 8 h + 2 t + u`` in slot ``2 h +
    u``. ``"bf16_fast"``: P = 1, ``bf(c)``; ``"bf16x3"``: P = 2, the
    high half ``bf(c)`` in slots 0-3 and ``bf(c - bf(c))`` in 4-7."""
    m, k, s = codebooks.shape
    kt, ks = -(-k // 8), -(-s // 16)
    cb = codebooks.to(torch.float32)
    halves = _split_codebooks(cb) if precision == "bf16x3" else (_bf16(cb),)
    out = []
    for half in halves:
        pad = torch.nn.functional.pad(half, (0, 16 * ks - s, 0, 8 * kt - k)).to(torch.bfloat16)
        frag = pad.view(m, kt, 8, ks, 2, 4, 2).permute(0, 1, 3, 2, 5, 4, 6)
        out.append(frag.reshape(m, kt, ks, 32, 4))
    return torch.cat(out, -1).contiguous()


def pq_encode_fused(x: torch.Tensor, codebooks: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """PQ encode: ``x [n, m*s]`` (f32 or bf16; f16 is upcast) against
    ``codebooks [m, k, s]`` -> codes ``[n, m]`` i32 under the int2 rule.
    ``precision``: ``"highest"`` (K4, exact f32), ``"bf16_fast"``
    (K4-bf16: one bf16 pass, a bf16 ``x`` stays bf16) or ``"bf16x3"``
    (K4-bf16x3: three bf16 passes, ``x`` upcast to f32), as
    ``pallas_kernels.pq_encode_fused`` takes them.

    On the card K4 is bit-identical to :func:`pq_encode_plain`; K4-bf16
    and K4-bf16x3 take their products on the tensor cores, which sum a
    tile's 16 products in their own order, so their codes are held to it
    by :func:`encode_parity` (float64 near ties, as on the TPU's matrix
    unit)."""
    _check_precision(precision)
    if x.dtype not in (torch.float32, torch.bfloat16) or precision == "bf16x3":
        x = x.to(torch.float32)
    cb = codebooks.to(torch.float32)
    if not _on_card(x, cb):
        return pq_encode_plain(x, cb, precision)
    m, k, s = _check_pq_operands(x, cb)
    x, cb = x.contiguous(), cb.contiguous()
    cc = (cb * cb).sum(-1).contiguous()
    n = x.shape[0]
    codes = torch.empty((n, m), dtype=torch.int32, device=x.device)
    if n == 0:
        return codes
    bf16 = int(x.dtype == torch.bfloat16)
    if precision == "highest":
        plan = pq_scan_plan(n, m, k, s)
        _launch(
            "vq_pq_encode", x.data_ptr(), bf16, cb.data_ptr(), cc.data_ptr(),
            codes.data_ptr(), n, m, k, s, int(plan.resident), plan.stages, plan.smem,
            plan.rows_per_block,
        )
    else:
        frag = mma_fragments(cb, precision)
        # a padded centroid's norm is NaN: its score never wins
        ccp = torch.nn.functional.pad(cc, (0, 8 * frag.shape[1] - k), value=float("nan"))
        _launch(
            "vq_pq_encode_lowp", x.data_ptr(), bf16, frag.data_ptr(), ccp.data_ptr(),
            codes.data_ptr(), n, m, k, s, max(1, -(-_LOWP_BLOCKS // m)),
            int(precision == "bf16x3"),
        )
    pq_encode_fused.launches += 1
    pq_encode_fused.launches_by[precision] += 1
    return codes


pq_encode_fused.launches = 0
pq_encode_fused.launches_by = dict.fromkeys(ENCODE_PRECISIONS, 0)


# ---------------------------------------------------------------------------
# K3: fused PQ Lloyd accumulate (replaces _pq_lloyd_acc_kernel).
# ---------------------------------------------------------------------------


def _pq_scan_plain(x: torch.Tensor, cb: torch.Tensor):
    """``(codes [n, m] i32, smin [n, m] f32)``: K4's arithmetic (the int2
    argmin of ``cc - 2 * dot`` and the minimum score itself) in
    ``_PLAIN_ROWS`` blocks."""
    n, (m, k, s) = x.shape[0], cb.shape
    cc = (cb * cb).sum(-1)
    codes = torch.empty((n, m), dtype=torch.int32, device=x.device)
    smin = torch.empty((n, m), dtype=torch.float32, device=x.device)
    for b0 in range(0, n, _PLAIN_ROWS):
        xs = x[b0:b0 + _PLAIN_ROWS].to(torch.float32).reshape(-1, m, s)
        smin[b0:b0 + _PLAIN_ROWS], codes[b0:b0 + _PLAIN_ROWS] = int_argmin(_scores_plain(xs, cb, cc))
    return codes, smin


def _k3_inertia(terms: torch.Tensor) -> torch.Tensor:
    """``terms``' sum in K3's inertia order: block b of ``_K3_BLOCK_TERMS``
    terms, thread t of ``_K3_TERM_THREADS`` adding terms b·1024 + t + 256·u
    in ascending u from +0.0, the 256 partials folded pairwise in halves,
    then the block partials in K2's order (:func:`_k2_inertia`)."""
    blocks = max(1, -(-terms.shape[0] // _K3_BLOCK_TERMS))
    v = torch.nn.functional.pad(terms, (0, blocks * _K3_BLOCK_TERMS - terms.shape[0]))
    v = v.view(blocks, -1, _K3_TERM_THREADS)
    acc = torch.zeros((blocks, _K3_TERM_THREADS), dtype=torch.float32, device=terms.device)
    for u in range(v.shape[1]):
        acc = acc + v[:, u]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return _k2_inertia(acc[:, 0])


def pq_lloyd_accumulate_plain(x: torch.Tensor, codebooks: torch.Tensor):
    """Plain version of K3 -> ``(sums [m, k, s], counts [m, k], inertia [])``,
    in the kernel's order: :func:`_pq_scan_plain`; the sums and counts of
    the ``[n·m, s]`` view of ``x`` labelled ``i·k + code`` (entry r·m + i:
    row r's subspace i) over m·k clusters, in the segmented order
    (:func:`_segment_sums_plain`, one call over all rows, since a cluster's
    segments cross row blocks); the inertia terms ``smin + xx`` (``xx``
    from +0.0 in ascending e, NaN kept, the rest clamped at 0) summed in
    row-major order in K3's order (:func:`_k3_inertia`)."""
    m, k, s = _check_pq_operands(x, codebooks)
    cb = codebooks.to(torch.float32)
    xf = x.to(torch.float32).reshape(-1, s)  # entry r·m + i
    codes, smin = _pq_scan_plain(x, cb)
    labels = (codes.to(torch.int64) + torch.arange(m, device=x.device) * k).reshape(-1)
    sums, counts = _segment_sums_plain(xf, labels, m * k)
    xx = torch.zeros((xf.shape[0],), dtype=torch.float32, device=x.device)
    for e in range(s):
        xx = xx + xf[:, e] * xf[:, e]
    t = smin.reshape(-1) + xx
    inertia = _k3_inertia(torch.where(torch.isnan(t), t, t.clamp_min(0.0)))
    return sums.reshape(m, k, s), counts.reshape(m, k), inertia


def _pq_lloyd_card(x: torch.Tensor, cb: torch.Tensor):
    """Launch K3 on contiguous f32 card tensors -> ``(sums, counts,
    inertia, minval [n, m])``: ``minval`` is the scan's minimum score of
    each (row, subspace), what the inertia terms add ``xx`` to."""
    m, k, s = _check_pq_operands(x, cb)
    n, dev = x.shape[0], x.device
    sums = torch.empty((m, k, s), dtype=torch.float32, device=dev)
    counts = torch.empty((m, k), dtype=torch.float32, device=dev)
    inertia = torch.empty((), dtype=torch.float32, device=dev)
    minval = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0:
        return sums.zero_(), counts.zero_(), inertia.zero_(), minval
    sc = _segment_scratch(n * m, m * k, s, dev, False)
    cc = (cb * cb).sum(-1).contiguous()
    plan = pq_scan_plan(n, m, k, s)
    codes = torch.empty((n, m), dtype=torch.int32, device=dev)  # the labels, in the end
    partials = torch.empty((-(-n * m // _K3_BLOCK_TERMS),), dtype=torch.float32, device=dev)
    vec = s % 4 == 0 and x.data_ptr() % 16 == 0
    _launch(
        "vq_pq_lloyd", x.data_ptr(), cb.data_ptr(), cc.data_ptr(), codes.data_ptr(),
        minval.data_ptr(), partials.data_ptr(), *sc.pointers(), sc.psums.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(), n, m, k, s, int(plan.resident),
        plan.stages, plan.smem, plan.rows_per_block, sc.rows_per_chunk, sc.chunks, sc.max_segs,
        int(vec),
    )
    pq_lloyd_accumulate_fused.launches += 1
    return sums, counts, inertia, minval


def pq_lloyd_accumulate_fused(x: torch.Tensor, codebooks: torch.Tensor):
    """One Lloyd pass over ``x [n, m*s]`` for all m subspaces ->
    ``(sums [m, k, s], counts [m, k], inertia [])``, all f32.

    On the card the result is bit-identical from run to run and to the
    plain version: both sum in one segmented order (``csrc/pq_lloyd.cu``:
    K4's scan, then K2's sums stage over the ``[n·m, s]`` view)."""
    x = x.to(torch.float32)
    cb = codebooks.to(torch.float32)
    if not _on_card(x, cb):
        return pq_lloyd_accumulate_plain(x, cb)
    return _pq_lloyd_card(x.contiguous(), cb.contiguous())[:3]


pq_lloyd_accumulate_fused.launches = 0


# ---------------------------------------------------------------------------
# K5: flat ADC scan + per-tile top-k (replaces _adc_scan_topk_kernel).
# ---------------------------------------------------------------------------


def adc_tile(n: int) -> int:
    """Corpus columns per K5 tile: a power of two in [128, 2048]."""
    return min(2048, max(TOP_LANES, 1 << max(int(n) - 1, 1).bit_length()))


def _check_adc(tables, codes_t, fetch, mode, qn2, offsets, pack_bits):
    if not 1 <= int(fetch) <= TOP_LANES:
        raise InvalidParameter("fetch", f"must be in [1, {TOP_LANES}]")
    if mode not in _ADC_MODES:
        raise InvalidParameter("mode", f"unknown mode {mode!r}")
    if mode == "l2" and (qn2 is None or offsets is None):
        raise InvalidParameter("mode", "mode='l2' requires qn2 and offsets")
    if int(pack_bits) not in (1, 2, 4, 8):
        raise InvalidParameter("pack_bits", "must be 1, 2, 4, or 8")
    if tables.ndim != 3 or tables.shape[2] > 256:
        raise InvalidParameter("tables", "expected [Q, m, k] with k <= 256")
    m = tables.shape[1]
    want = m if pack_bits == 8 else -(-m * int(pack_bits) // 8)
    if codes_t.ndim != 2 or codes_t.shape[0] != want:
        raise InvalidParameter(
            "codes_t", f"must have {want} rows, got {tuple(codes_t.shape)}"
        )


def _unpack_t(codes_t: torch.Tensor, m: int, pack_bits: int) -> torch.Tensor:
    """``[rows, n]`` u8 -> ``[m, n]`` int64 codes (the kernel's unpack)."""
    c = codes_t.to(torch.int64)
    if pack_bits == 8:
        return c
    per = 8 // pack_bits
    i = torch.arange(m, device=c.device)
    return (c[i // per] >> ((i % per) * pack_bits)[:, None]) & ((1 << pack_bits) - 1)


def adc_scan_topk_plain(
    tables, codes_t, fetch: int, *, mode: str = "sum", qn2=None,
    offsets=None, pack_bits: int = 8, tile: Optional[int] = None,
):
    """Plain version of K5, bit-identical to it: same summation order,
    same mode arithmetic, same (key, column) order inside each tile."""
    _check_adc(tables, codes_t, fetch, mode, qn2, offsets, pack_bits)
    q, m, k = tables.shape
    n = codes_t.shape[1]
    tile = adc_tile(n) if tile is None else int(tile)
    kpad = 128 if k <= 128 else 256
    tab = torch.nn.functional.pad(tables.to(torch.float32), (0, kpad - k))
    codes = _unpack_t(codes_t, m, int(pack_bits)) & (kpad - 1)
    acc = torch.zeros((q, n), dtype=torch.float32, device=tables.device)
    for i in range(m):
        acc = acc + tab[:, i, :][:, codes[i]]
    if mode == "l2":
        t = (qn2.to(torch.float32)[:, None] - 2.0 * acc) + offsets.to(torch.float32)[None, :]
        acc = torch.where(torch.isnan(t), t, t.clamp_min(0.0))
    elif mode == "dot":
        acc = -acc
    ntiles = -(-n // tile)
    key = torch.full((q, ntiles * tile), _INF_KEY, dtype=torch.int32, device=acc.device)
    key[:, :n] = orderable_key(acc)
    skey, pos = torch.sort(key.view(q, ntiles, tile), dim=-1, stable=True)
    lanes = min(TOP_LANES, tile)
    skey, pos = skey[..., :lanes], pos[..., :lanes]
    lane = torch.arange(lanes, device=acc.device)
    hit = (skey < _INF_KEY) & (lane < int(fetch))
    base = torch.arange(ntiles, device=acc.device)[:, None] * tile
    vals = torch.full((q, ntiles, TOP_LANES), float("inf"), device=acc.device)
    ids = torch.full((q, ntiles, TOP_LANES), -1, dtype=torch.int32, device=acc.device)
    vals[..., :lanes] = torch.where(hit, key_to_f32(skey), float("inf"))
    ids[..., :lanes] = torch.where(hit, (pos + base).to(torch.int32), -1)
    return vals.reshape(q, -1), ids.reshape(q, -1)


def adc_scan_topk_fused(
    tables, codes_t, fetch: int, *, mode: str = "sum", qn2=None,
    offsets=None, pack_bits: int = 8, tile: Optional[int] = None,
):
    """Per-tile top-``fetch`` ADC candidates without materializing
    ``[Q, n]``.

    ``tables [Q, m, k<=256]`` f32; ``codes_t [m, n]`` u8 codes transposed
    (``[ceil(m*b/8), n]`` when sub-byte packed with ``pack_bits`` b). Returns
    ``(vals [Q, T*128], ids [Q, T*128])``: tile ``t`` of ``tile`` columns
    holds its best ``fetch`` in lanes ``[t*128, t*128+fetch)``, ascending
    (value, id), padded with inf / -1; merge the first ``fetch`` lanes of
    each tile with one stable sort (``models.pq._merge_candidates``). Modes:
    ``"sum"`` (PQ), ``"l2"`` (``max(qn2 - 2*sum + offsets, 0)``, pass
    ``qn2 [Q]`` and ``offsets [n]``) and ``"dot"`` (``-sum``)."""
    _check_adc(tables, codes_t, fetch, mode, qn2, offsets, pack_bits)
    operands = [tables, codes_t] + ([qn2, offsets] if mode == "l2" else [])
    if not _on_card(*operands):
        return adc_scan_topk_plain(
            tables, codes_t, fetch, mode=mode, qn2=qn2, offsets=offsets,
            pack_bits=pack_bits, tile=tile,
        )
    q, m, k = tables.shape
    n = codes_t.shape[1]
    tile = adc_tile(n) if tile is None else int(tile)
    if tile < TOP_LANES or tile > 2048 or tile & (tile - 1):
        raise InvalidParameter("tile", "must be a power of two in [128, 2048]")
    tables = tables.to(torch.float32).contiguous()
    codes_t = codes_t.to(torch.uint8).contiguous()
    if mode == "l2":
        qn2 = qn2.to(torch.float32).contiguous()
        offsets = offsets.to(torch.float32).contiguous()
    kpad = 128 if k <= 128 else 256
    ntiles = -(-n // tile)
    vals = torch.empty((q, ntiles * TOP_LANES), dtype=torch.float32, device=tables.device)
    ids = torch.empty((q, ntiles * TOP_LANES), dtype=torch.int32, device=tables.device)
    if q == 0 or n == 0:
        return vals, ids
    tab_in_smem = m * kpad * 4 <= _SMEM_BYTES
    l2 = mode == "l2"
    _launch(
        "vq_adc_topk", tables.data_ptr(), codes_t.data_ptr(),
        qn2.data_ptr() if l2 else None, offsets.data_ptr() if l2 else None,
        vals.data_ptr(), ids.data_ptr(),
        q, m, k, kpad, n, tile, int(fetch), _ADC_MODES[mode], int(pack_bits),
        int(tab_in_smem), ntiles,
    )
    adc_scan_topk_fused.launches += 1
    return vals, ids


adc_scan_topk_fused.launches = 0


# ---------------------------------------------------------------------------
# K7: ADC sums over probed IVF chunks (replaces _ivf_probe_gather_kernel
# and _ivf_probe_kernel).
# ---------------------------------------------------------------------------


def _chains(probe, pairs: int, rows: int, cap):
    """``(chunks [P, nc] i32, width, cap)`` of a probe over a pool of
    ``rows``-row chunks: a ``[P]`` probe is one chunk a pair (the TPU
    contract), a ``[P, nc]`` probe a chain (K6 and K7)."""
    chunks = probe.to(torch.int32)
    if chunks.ndim == 1:
        chunks = chunks[:, None]
    if chunks.ndim != 2 or chunks.shape[0] != pairs:
        raise InvalidParameter(
            "probe", f"expected [{pairs}] or [{pairs}, nc], got {tuple(probe.shape)}"
        )
    width = chunks.shape[1] * rows
    return chunks, width, width if cap is None else int(cap)


def _probe_operands(tables, probe, bucket_codes, cap):
    if tables.ndim != 3:
        raise InvalidParameter("tables", "expected [P, m, kk]")
    if bucket_codes.ndim != 3 or bucket_codes.shape[2] != tables.shape[1]:
        raise InvalidParameter(
            "bucket_codes", f"expected [chunks, rows, {tables.shape[1]}], "
            f"got {tuple(bucket_codes.shape)}"
        )
    return _chains(probe, tables.shape[0], bucket_codes.shape[1], cap)


def ivf_probe_adc_plain(tables, probe, bucket_codes, *, cap: Optional[int] = None):
    """Plain version of K7, bit-identical to it (same summation order, the
    same zeros for dead positions and out-of-range codes)."""
    chunks, width, cap = _probe_operands(tables, probe, bucket_codes, cap)
    p, m, kk = tables.shape
    n_chunks, ch = bucket_codes.shape[:2]
    dev = tables.device
    t = torch.arange(width, device=dev)
    cid = chunks.to(torch.int64)[:, t // ch]  # [P, W]
    ok = (cid >= 0) & (cid < n_chunks)
    live = ok & (t < cap)
    base = (torch.where(ok, cid, 0) * ch + t % ch) * m
    flat = bucket_codes.reshape(-1)
    tab = tables.to(torch.float32)
    acc = torch.zeros((p, width), dtype=torch.float32, device=dev)
    for i in range(m):
        code = flat[base + i].to(torch.int64)
        ok = (code >= 0) & (code < kk)
        g = torch.gather(tab[:, i, :], 1, torch.where(ok, code, 0))
        acc = acc + torch.where(ok, g, 0.0)
    return torch.where(live, acc, 0.0)


def ivf_probe_adc_fused(tables, probe, bucket_codes, *, cap: Optional[int] = None):
    """ADC sums of probed IVF chunks.

    ``tables [P, m, kk]`` f32, one lookup table per (query, probe) pair;
    ``bucket_codes [chunks, rows, m]`` integer codes (u8 stays u8, any
    other type runs as i32). ``probe [P]`` names one chunk per pair, the
    TPU kernel's contract, -> ``[P, rows]``; ``probe [P, nc]`` is a chain
    of chunk ids per pair (-1 = none) -> ``[P, nc*rows]``. Positions at or
    past ``cap`` (default: all of them kept) and positions of a chunk id
    outside ``[0, chunks)`` are 0; the caller masks them with the row
    ids."""
    tables = tables.to(torch.float32)
    if not _on_card(tables, probe, bucket_codes):
        return ivf_probe_adc_plain(tables, probe, bucket_codes, cap=cap)
    chunks, width, cap = _probe_operands(tables, probe, bucket_codes, cap)
    p, m, kk = tables.shape
    tables, chunks = tables.contiguous(), chunks.contiguous()
    u8 = bucket_codes.dtype == torch.uint8
    codes = (bucket_codes if u8 else bucket_codes.to(torch.int32)).contiguous()
    out = torch.empty((p, width), dtype=torch.float32, device=tables.device)
    if p == 0 or width == 0:
        return out
    gsub = min(m, _SMEM_BYTES // (kk * 4))  # 0: tables read from device memory
    slices = max(1, min(-(-width // _PROBE_THREADS), -(-_TARGET_BLOCKS // p)))
    _launch(
        "vq_ivf_probe", tables.data_ptr(), chunks.data_ptr(), codes.data_ptr(),
        int(u8), out.data_ptr(), p, m, kk, chunks.shape[1], codes.shape[1],
        codes.shape[0], cap, gsub, slices,
    )
    ivf_probe_adc_fused.launches += 1
    return out


ivf_probe_adc_fused.launches = 0


# ---------------------------------------------------------------------------
# K6: dots with the rows of probed IVF chunks at stored width (replaces
# _ivf_matvec_kernel).
# ---------------------------------------------------------------------------


def _matvec_operands(qvecs, probe, payload, cap):
    if qvecs.ndim != 2:
        raise InvalidParameter("qvecs", f"expected [P, d], got {tuple(qvecs.shape)}")
    if payload.ndim != 3 or payload.shape[2] != qvecs.shape[1]:
        raise InvalidParameter(
            "payload", f"expected [chunks, rows, {qvecs.shape[1]}], got {tuple(payload.shape)}"
        )
    if payload.dtype not in _PAYLOAD_TYPES:
        raise InvalidParameter(
            "payload", f"must be float32, bfloat16, float16 or uint8, got {payload.dtype}"
        )
    return _chains(probe, qvecs.shape[0], payload.shape[1], cap)


def ivf_probe_matvec_plain(qvecs, probe, payload, *, cap: Optional[int] = None):
    """Plain version of K6, bit-identical to it: each dot summed from 0 in
    ascending dimension order, one rounded multiply and add at a time, and
    0 for dead positions. Works through the pairs in blocks of at most
    ``_PLAIN_CELLS_K6`` gathered values."""
    chunks, width, cap = _matvec_operands(qvecs, probe, payload, cap)
    p, d = qvecs.shape
    (n_chunks, ch), dev = payload.shape[:2], qvecs.device
    lhs = qvecs.to(torch.float32)
    out = torch.zeros((p, width), dtype=torch.float32, device=dev)
    live_pos = torch.arange(width, device=dev) < cap
    step = max(1, _PLAIN_CELLS_K6 // max(1, width * d))
    for b0 in range(0, p, step):
        cid = chunks[b0:b0 + step].to(torch.int64)  # [B, nc]
        ok = (cid >= 0) & (cid < n_chunks)
        rows = payload[torch.where(ok, cid, 0)].reshape(cid.shape[0], width, d)
        rows_t = torch.empty((cid.shape[0], d, width), dtype=torch.float32, device=dev)
        rows_t.copy_(rows.transpose(1, 2))  # [B, d, W] f32: contiguous per dimension
        acc = torch.zeros((cid.shape[0], width), dtype=torch.float32, device=dev)
        for e in range(d):
            acc = acc + lhs[b0:b0 + step, e, None] * rows_t[:, e]
        live = ok.repeat_interleave(ch, dim=1) & live_pos
        out[b0:b0 + step] = torch.where(live, acc, 0.0)
    return out


def _k6_segments(entries: int, n_chunks: int) -> Tuple[int, int]:
    """``(seg_len, segs)`` of K6's work-list pass (one warp a segment of
    ``seg_len`` entries): at least ``_K6_SEGMENT`` entries, a multiple of
    32, and few enough segments that the (chunk, segment) counts stay
    within ``_K6_TABLE_CELLS``."""
    most = max(1, _K6_TABLE_CELLS // max(1, n_chunks))
    warp_steps = -(-entries // (32 * most))
    seg_len = 32 * max(_K6_SEGMENT // 32, warp_steps)
    return seg_len, max(1, -(-entries // seg_len))


class _K6Scratch(NamedTuple):
    buf: torch.Tensor  # the i32 scratch of csrc/ivf_matvec.cu
    seg_len: int
    segs: int
    offsets: torch.Tensor  # view: [n_chunks + 1], each chunk's first work slot
    work: torch.Tensor  # view: [E], the work list's slots


def _k6_scratch(chunks, n_chunks: int) -> _K6Scratch:
    """K6's scratch over ``chunks [P, nc]``: tasks (int4), the (chunk,
    segment) counts, totals, offsets, task offsets, ranks and the work
    list, as csrc/ivf_matvec.cu's ``Scratch`` lays them out."""
    entries = chunks.numel()
    if entries >= 2 ** 31:
        raise InvalidParameter("probe", f"{entries} (pair, chunk) entries; K6 takes fewer than 2^31")
    seg_len, segs = _k6_segments(entries, n_chunks)
    base = 4 * (n_chunks + -(-entries // _K6_TASK)) + n_chunks * (segs + 1)  # offsets' start
    buf = torch.empty(base + 2 * (n_chunks + 1) + 2 * entries, dtype=torch.int32,
                      device=chunks.device)
    return _K6Scratch(buf, seg_len, segs, buf[base:base + n_chunks + 1],
                      buf[base + 2 * (n_chunks + 1) + entries:])


def ivf_matvec_work_list_plain(chains, n_chunks: int, ch: int, cap: Optional[int] = None):
    """Plain version of K6's work list. Entry ``i = p * nc + s`` of
    ``chains [P, nc]`` (pair p, chain slot s; a ``[P]`` probe is one slot)
    is live when its chunk id lies in ``[0, n_chunks)`` and ``s * ch <
    cap``. Returns ``(offsets [n_chunks + 1], work [live])`` i32: chunk
    c's live entries, ascending, are ``work[offsets[c]:offsets[c + 1]]``."""
    chunks, width, cap = _chains(chains, chains.shape[0], ch, cap)
    flat = chunks.reshape(-1).to(torch.int64)
    i = torch.arange(flat.numel(), device=flat.device)
    live = (flat >= 0) & (flat < n_chunks) & ((i % chunks.shape[1]) * ch < cap)
    ids, codes = i[live], flat[live]
    offsets = torch.zeros(n_chunks + 1, dtype=torch.int64, device=flat.device)
    offsets[1:] = torch.bincount(codes, minlength=n_chunks).cumsum(0)
    return offsets.to(torch.int32), ids[torch.sort(codes, stable=True).indices].to(torch.int32)


def ivf_matvec_work_list(chains, n_chunks: int, ch: int, cap: Optional[int] = None):
    """K6's work list (:func:`ivf_matvec_work_list_plain`), built on the
    card by the kernel's own pass for a CUDA ``chains``."""
    if not _on_card(chains):
        return ivf_matvec_work_list_plain(chains, n_chunks, ch, cap)
    chunks, width, cap = _chains(chains, chains.shape[0], ch, cap)
    chunks = chunks.contiguous()
    sc = _k6_scratch(chunks, n_chunks)
    _launch("vq_ivf_matvec_plan", chunks.data_ptr(), sc.buf.data_ptr(), *chunks.shape, ch,
            n_chunks, cap, sc.seg_len, sc.segs)
    return sc.offsets, sc.work[:int(sc.offsets[-1])]


def ivf_probe_matvec_fused(qvecs, probe, payload, *, cap: Optional[int] = None):
    """Dots of per-(query, probe) vectors with the rows of probed IVF
    chunks, read at stored width.

    ``qvecs [P, d]`` f32 left vectors; ``payload [chunks, rows, d]`` f32,
    bf16 or f16 rows (IVF-Flat) or u8 codes (IVF-SQ), converted to f32 as
    they are read. ``probe [P]`` names one chunk a pair, the TPU kernel's
    contract, -> ``[P, rows]``; ``probe [P, nc]`` is a chain of chunk ids
    a pair (-1 = none) -> ``[P, nc*rows]``. Positions at or past ``cap``
    (default: all kept) and positions of a chunk id outside ``[0,
    chunks)`` are 0; the caller masks them with the row ids. On the card
    the kernel works chunk by chunk (``csrc/ivf_matvec.cu``): a pass
    builds the work list (:func:`ivf_matvec_work_list`), then each probed
    chunk is read once for up to 32 of the pairs that probe it, by blocks
    that also write every dead position's zero."""
    qvecs = qvecs.to(torch.float32)
    if not _on_card(qvecs, probe, payload):
        return ivf_probe_matvec_plain(qvecs, probe, payload, cap=cap)
    chunks, width, cap = _matvec_operands(qvecs, probe, payload, cap)
    (p, d), (n_chunks, ch) = qvecs.shape, payload.shape[:2]
    lhs, chunks, payload = qvecs.contiguous(), chunks.contiguous(), payload.contiguous()
    out = torch.empty((p, width), dtype=torch.float32, device=lhs.device)
    if p == 0 or width == 0:
        return out
    vec = (d * payload.element_size()) % 16 == 0 and payload.data_ptr() % 16 == 0
    qvec = d % 4 == 0 and lhs.data_ptr() % 16 == 0
    sc = _k6_scratch(chunks, n_chunks)
    _launch(
        "vq_ivf_matvec", lhs.data_ptr(), chunks.data_ptr(), payload.data_ptr(),
        _PAYLOAD_TYPES[payload.dtype], out.data_ptr(), sc.buf.data_ptr(), p, d, chunks.shape[1],
        ch, n_chunks, cap, sc.seg_len, sc.segs, int(vec), int(qvec),
    )
    ivf_probe_matvec_fused.launches += 1
    return out


ivf_probe_matvec_fused.launches = 0


# ---------------------------------------------------------------------------
# K8: dense ADC table sum (replaces _adc_lookup_kernel).
# ---------------------------------------------------------------------------


def _check_lookup(tables, codes):
    if tables.ndim != 3:
        raise InvalidParameter("tables", f"expected [Q, m, k], got {tuple(tables.shape)}")
    if codes.ndim != 2 or codes.shape[1] != tables.shape[1]:
        raise InvalidParameter(
            "codes", f"expected [n, {tables.shape[1]}], got {tuple(codes.shape)}"
        )


def adc_lookup_plain(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of K8, bit-identical to it: ``[Q, n]``, the table
    entries the codes pick added from +0.0 in ascending subspace order, a
    code outside ``[0, k)`` adding 0.0."""
    _check_lookup(tables, codes)
    k = tables.shape[2]
    tab = tables.to(torch.float32)
    c = codes.to(torch.int64)
    ok = (c >= 0) & (c < k)
    c = torch.where(ok, c, 0)
    acc = torch.zeros((tab.shape[0], c.shape[0]), dtype=torch.float32, device=tab.device)
    for i in range(tab.shape[1]):
        acc = acc + torch.where(ok[:, i], tab[:, i, :][:, c[:, i]], 0.0)
    return acc


def adc_lookup_fused(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Dense asymmetric-distance lookup: ``tables [Q, m, k]`` f32 (one
    table a query and subspace, or stage) and ``codes [n, m]`` integer
    code words (u8 stays u8, any other type runs as i32) -> ``[Q, n]``
    f32, the sum of the picked entries; a code outside ``[0, k)`` adds
    0."""
    tables = tables.to(torch.float32)
    if not _on_card(tables, codes):
        return adc_lookup_plain(tables, codes)
    _check_lookup(tables, codes)
    q, m, k = tables.shape
    n = codes.shape[0]
    u8 = codes.dtype == torch.uint8
    if not u8 and codes.dtype != torch.int32:  # out-of-range stays out of range
        codes = codes.clamp(-1, k).to(torch.int32)
    tables, codes = tables.contiguous(), codes.contiguous()
    out = torch.empty((q, n), dtype=torch.float32, device=tables.device)
    if q == 0 or n == 0 or m * k == 0:
        return out.zero_()
    group = min(q, _SMEM_BYTES // (m * k * 4))  # 0: tables read from device memory
    in_smem = group > 0
    group = max(group, 1)
    groups = -(-q // group)
    row_blocks = max(1, min(-(-n // _LOOKUP_THREADS), -(-4 * _TARGET_BLOCKS // groups)))
    rows = -(-n // row_blocks)
    rows = -(-rows // _LOOKUP_THREADS) * _LOOKUP_THREADS
    _launch(
        "vq_adc_lookup", tables.data_ptr(), codes.data_ptr(), int(u8), out.data_ptr(),
        q, m, k, n, group, int(in_smem), rows,
    )
    adc_lookup_fused.launches += 1
    return out


adc_lookup_fused.launches = 0
