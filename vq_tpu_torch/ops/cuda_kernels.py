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

from typing import Optional, Tuple

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
    "ENCODE_PRECISIONS",
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
]

_INT_MAX = 0x7FFFFFFF
_INF_KEY = 0x7F800000  # orderable_key(+inf)
TOP_LANES = 128  # candidate lanes per tile, as on the TPU
_THREADS = 256  # rows per tile in K3 and K4 (csrc/common.cuh kThreads)
_SMEM_BYTES = 48 * 1024  # shared memory a block uses without opting in
_TARGET_BLOCKS = 132 * 8  # SMs x resident 256-thread blocks
_PARTIAL_BYTES = 256 << 20  # K3's per-block partial sums, at most
_ADC_MODES = {"sum": 0, "l2": 1, "dot": 2}
_PLAIN_ROWS = 16_384  # row block of the plain K3/K4 ([B, m, k] scores)
_PLAIN_CELLS = 1 << 22  # [B, k] scores per block of the plain K1
_CHUNK_ROWS = 1024  # K2's rows per counting-sort chunk, at least
_CHUNK_CELLS = 1 << 24  # K2's (chunk, cluster) cursors, at most
_INERTIA_THREADS = 1024  # K2's inertia partial sums (csrc/lloyd.cu kScanThreads)
_SEGMENT_ROWS = 32  # K2's rows a segment of a cluster's sum (csrc/lloyd.cu kSegRows)
_PROBE_THREADS = 256  # row positions per K7 block step (csrc/ivf_probe.cu)
_MATVEC_ROWS = 256  # row positions per K6 tile (csrc/ivf_matvec.cu kRows)
_PLAIN_CELLS_K6 = 1 << 28  # gathered f32 values per block of the plain K6
_PAYLOAD_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.uint8: 3}
ENCODE_PRECISIONS = ("highest", "bf16_fast", "bf16x3")  # K4, K4-bf16, K4-bf16x3
_LOOKUP_THREADS = 256  # rows per K8 tile (csrc/adc_lookup.cu kLookupThreads)


# ---------------------------------------------------------------------------
# The int2 argmin rule (pallas_kernels.py::_orderable_key / _int_argmin).
# ---------------------------------------------------------------------------


def orderable_key(scores: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> i32 map: integer order equals float order, NaN
    keys above +inf, and -0.0 shares +0.0's key."""
    b = scores.contiguous().view(torch.int32)
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


def _centroid_chunk(k: int, s: int, extra_bytes: int, copies: int = 1) -> int:
    """Centroids of one subspace staged in shared memory at a time
    (``copies`` values a coordinate, plus the squared norm)."""
    kc = (_SMEM_BYTES - extra_bytes) // ((copies * s + 1) * 4)
    if kc < 1:
        raise InvalidParameter(
            "codebooks", f"sub_dim {s} leaves no room for one centroid in "
            "shared memory"
        )
    return min(k, kc)


def _rows_per_block(n: int, m: int, cap_blocks: Optional[int] = None) -> int:
    """Rows each (row range, subspace) block owns: enough blocks to fill
    the card, in whole 256-row tiles."""
    chunks = max(1, _TARGET_BLOCKS // max(m, 1))
    if cap_blocks is not None:
        chunks = max(1, min(chunks, cap_blocks))
    rows = -(-n // chunks)
    return -(-rows // _THREADS) * _THREADS


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


def lloyd_accumulate_plain(x: torch.Tensor, centroids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None):
    """Plain version of K2 -> ``(sums [k, d], counts [k], inertia [])``, in
    the kernel's segmented order: :func:`assign_plain`; each cluster's rows,
    in ascending row order, cut into segments of ``_SEGMENT_ROWS`` (S)
    rows; each segment's partial added from +0.0 in ascending row order,
    one rounded add a row; each cluster's partials added to +0.0 in
    ascending segment order. With ``weights [n]`` the terms are w·x, each
    product rounded before it is added, and the counts Σ w in the same
    order; without, the counts are the exact row counts. The inertia is
    Σ d (Σ w·d) in K2's order. S steps over the position in a segment, each
    adding one row to every segment that has one, then one step a segment
    of the largest cluster, each adding one partial to every cluster that
    still has one (O(n·d + k·S·d) work in all)."""
    codes, dists = assign_plain(x, centroids)
    (n, d), k, dev = x.shape, centroids.shape[0], x.device
    w = _check_weights(weights, n)
    idx = codes.to(torch.int64)
    rows = torch.sort(idx, stable=True)[1]  # by cluster, ascending rows within each
    totals = torch.bincount(idx, minlength=k)
    ends = torch.cumsum(totals, 0)
    nseg = -(-totals // _SEGMENT_ROWS)
    seg_off = torch.cumsum(nseg, 0) - nseg
    seg_cluster = torch.repeat_interleave(torch.arange(k, device=dev), nseg)
    seg = torch.arange(seg_cluster.shape[0], device=dev) - seg_off[seg_cluster]
    end = ends[seg_cluster]  # one past each segment's cluster's last position
    first = end - totals[seg_cluster] + seg * _SEGMENT_ROWS
    xf = x.to(torch.float32)
    part = torch.zeros((seg_cluster.shape[0], d), dtype=torch.float32, device=dev)
    wpart = torch.zeros((seg_cluster.shape[0],), dtype=torch.float32, device=dev)
    for t in range(_SEGMENT_ROWS if n else 0):
        pos = first + t
        has_row = pos < end
        r = rows[pos.clamp(max=n - 1)]
        term = xf[r] if w is None else w[r, None] * xf[r]
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
    return sums, counts, _k2_inertia(dists if w is None else w * dists)


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
    chunks = max(1, min(-(-n // _CHUNK_ROWS), _CHUNK_CELLS // k))
    rows = -(-n // chunks)
    chunks = -(-n // rows)
    max_segs = n // _SEGMENT_ROWS + min(k, n)  # sum of ceil(total / S)
    max_parts = max(1, 2 * n // _SEGMENT_ROWS)  # segments of clusters of > S rows
    i32 = dict(dtype=torch.int32, device=dev)
    codes, perm = torch.empty((n,), **i32), torch.empty((n,), **i32)
    dists = torch.empty((n,), dtype=torch.float32, device=dev)
    chunk_counts = torch.empty((chunks, k), **i32)
    totals, offsets = torch.empty((k,), **i32), torch.empty((k,), **i32)
    seg_off, pseg_off = torch.empty((k + 1,), **i32), torch.empty((k,), **i32)
    seg_cluster = torch.empty((max_segs,), **i32)
    psums = torch.empty((max_parts, d), dtype=torch.float32, device=dev)
    pcounts = None if w is None else torch.empty((max_parts,), dtype=torch.float32, device=dev)
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    _launch(
        "vq_lloyd", x.data_ptr(), None if w is None else w.data_ptr(), c.data_ptr(),
        cc.data_ptr(), codes.data_ptr(), dists.data_ptr(), chunk_counts.data_ptr(),
        totals.data_ptr(), offsets.data_ptr(), perm.data_ptr(), seg_off.data_ptr(),
        pseg_off.data_ptr(), seg_cluster.data_ptr(), psums.data_ptr(),
        None if pcounts is None else pcounts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        inertia.data_ptr(), n, k, d, rows, chunks, max_segs, int(vec),
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


def pq_encode_fused(x: torch.Tensor, codebooks: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """PQ encode: ``x [n, m*s]`` (f32 or bf16; f16 is upcast) against
    ``codebooks [m, k, s]`` -> codes ``[n, m]`` i32 under the int2 rule.
    ``precision``: ``"highest"`` (K4, exact f32), ``"bf16_fast"``
    (K4-bf16: one bf16 pass, a bf16 ``x`` stays bf16) or ``"bf16x3"``
    (K4-bf16x3: three bf16 passes, ``x`` upcast to f32), as
    ``pallas_kernels.pq_encode_fused`` takes them."""
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
        _launch(
            "vq_pq_encode", x.data_ptr(), bf16, cb.data_ptr(), cc.data_ptr(),
            codes.data_ptr(), n, m, k, s, _centroid_chunk(k, s, 0), _rows_per_block(n, m),
        )
    else:
        x3 = precision == "bf16x3"
        cbh, cbl = _split_codebooks(cb) if x3 else (_bf16(cb), cb)
        cbh, cbl = cbh.contiguous(), cbl.contiguous()
        _launch(
            "vq_pq_encode_lowp", x.data_ptr(), bf16, cbh.data_ptr(), cbl.data_ptr(),
            cc.data_ptr(), codes.data_ptr(), n, m, k, s,
            _centroid_chunk(k, s, 0, copies=2 if x3 else 1), _rows_per_block(n, m), int(x3),
        )
    pq_encode_fused.launches += 1
    pq_encode_fused.launches_by[precision] += 1
    return codes


pq_encode_fused.launches = 0
pq_encode_fused.launches_by = dict.fromkeys(ENCODE_PRECISIONS, 0)


# ---------------------------------------------------------------------------
# K3: fused PQ Lloyd accumulate (replaces _pq_lloyd_acc_kernel).
# ---------------------------------------------------------------------------


def pq_lloyd_accumulate_plain(x: torch.Tensor, codebooks: torch.Tensor):
    """Plain version of K3 -> ``(sums [m, k, s], counts [m, k], inertia [])``."""
    m, k, s = _check_pq_operands(x, codebooks)
    cb = codebooks.to(torch.float32)
    cc = (cb * cb).sum(-1)
    dev = x.device
    sums = torch.zeros((m * k, s), dtype=torch.float32, device=dev)
    counts = torch.zeros((m * k,), dtype=torch.int64, device=dev)
    inertia = torch.zeros((), dtype=torch.float32, device=dev)
    offs = torch.arange(m, device=dev) * k
    for b0 in range(0, x.shape[0], _PLAIN_ROWS):
        xs = x[b0:b0 + _PLAIN_ROWS].to(torch.float32).reshape(-1, m, s)
        smin, idx = int_argmin(_scores_plain(xs, cb, cc))
        flat = (idx.to(torch.int64) + offs).reshape(-1)
        sums.index_add_(0, flat, xs.reshape(-1, s))
        counts += torch.bincount(flat, minlength=m * k)
        t = smin + (xs * xs).sum(-1)
        inertia = inertia + torch.where(torch.isnan(t), t, t.clamp_min(0.0)).sum()
    return sums.reshape(m, k, s), counts.reshape(m, k).to(torch.float32), inertia


def pq_lloyd_accumulate_fused(x: torch.Tensor, codebooks: torch.Tensor):
    """One Lloyd pass over ``x [n, m*s]`` for all m subspaces ->
    ``(sums [m, k, s], counts [m, k], inertia [])``, all f32.

    On the card the result is deterministic from run to run; against the
    plain version counts are exact and sums and inertia differ by fp32
    summation order only (``csrc/pq_lloyd.cu``)."""
    x = x.to(torch.float32)
    cb = codebooks.to(torch.float32)
    if not _on_card(x, cb):
        return pq_lloyd_accumulate_plain(x, cb)
    m, k, s = _check_pq_operands(x, cb)
    x, cb = x.contiguous(), cb.contiguous()
    n, dev = x.shape[0], x.device
    sums = torch.zeros((m, k, s), dtype=torch.float32, device=dev)
    counts = torch.zeros((m, k), dtype=torch.float32, device=dev)
    inertia = torch.zeros((), dtype=torch.float32, device=dev)
    if n == 0:
        return sums, counts, inertia
    cc = (cb * cb).sum(-1).contiguous()
    kc = _centroid_chunk(k, s, 2 * _THREADS * 4)
    rpb = _rows_per_block(n, m, _PARTIAL_BYTES // (m * k * s * 4))
    chunks = -(-n // rpb)
    psums = torch.empty((chunks, m, k, s), dtype=torch.float32, device=dev)
    pcounts = torch.empty((chunks, m, k), dtype=torch.int32, device=dev)
    pinertia = torch.empty((chunks, m), dtype=torch.float32, device=dev)
    _launch(
        "vq_pq_lloyd", x.data_ptr(), cb.data_ptr(), cc.data_ptr(),
        psums.data_ptr(), pcounts.data_ptr(), pinertia.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(),
        n, m, k, s, kc, rpb, chunks,
    )
    pq_lloyd_accumulate_fused.launches += 1
    return sums, counts, inertia


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
    (value, id), padded with inf / -1; merge with one stable sort. Modes:
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
    tab_in_smem = tile * 8 + m * kpad * 4 <= _SMEM_BYTES
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


def ivf_probe_matvec_fused(qvecs, probe, payload, *, cap: Optional[int] = None):
    """Dots of per-(query, probe) vectors with the rows of probed IVF
    chunks, read at stored width.

    ``qvecs [P, d]`` f32 left vectors; ``payload [chunks, rows, d]`` f32,
    bf16 or f16 rows (IVF-Flat) or u8 codes (IVF-SQ), converted to f32 as
    they are read. ``probe [P]`` names one chunk a pair, the TPU kernel's
    contract, -> ``[P, rows]``; ``probe [P, nc]`` is a chain of chunk ids
    a pair (-1 = none) -> ``[P, nc*rows]``. Positions at or past ``cap``
    (default: all kept) and positions of a chunk id outside ``[0,
    chunks)`` are 0; the caller masks them with the row ids."""
    qvecs = qvecs.to(torch.float32)
    if not _on_card(qvecs, probe, payload):
        return ivf_probe_matvec_plain(qvecs, probe, payload, cap=cap)
    chunks, width, cap = _matvec_operands(qvecs, probe, payload, cap)
    (p, d), ch = qvecs.shape, payload.shape[1]
    lhs, chunks, payload = qvecs.contiguous(), chunks.contiguous(), payload.contiguous()
    out = torch.empty((p, width), dtype=torch.float32, device=lhs.device)
    if p == 0 or width == 0:
        return out
    vec = (d * payload.element_size()) % 16 == 0 and payload.data_ptr() % 16 == 0
    slices = max(1, min(-(-width // _MATVEC_ROWS), -(-_TARGET_BLOCKS // p)))
    _launch(
        "vq_ivf_matvec", lhs.data_ptr(), chunks.data_ptr(), payload.data_ptr(),
        _PAYLOAD_TYPES[payload.dtype], out.data_ptr(), p, d, chunks.shape[1], ch,
        payload.shape[0], cap, int(vec), slices,
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
