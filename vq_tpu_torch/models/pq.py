"""Product quantization — the port of ``vq_tpu.models.pq``.

m sub-codebooks trained together with Lloyd's algorithm (K3 on the card),
encode (K4 and its lower-precision forms), decode, per-query ADC lookup
tables, the dense ADC table sum (K8) and the flat ADC top-k search (K5). Training assignment is always squared-L2; the
quantizer's metric applies at encode and search time. Encode ties keep
the lowest index, and NaN scores never win (the int2 rule of
``vq_tpu_torch.ops.cuda_kernels``).

Routes, as in the JAX package:

* encode: the L2 family goes through :func:`pq_encode_fused`:
  ``precision="highest"`` to K4 (exact f32), ``"high"`` / ``"bf16x3"`` to
  K4-bf16x3 and ``"default"`` / ``"bf16_fast"`` to K4-bf16. The JAX
  package computes the two lower precisions with an m-packed XLA matmul
  (on its CPU backend "high" is exact f32); the port computes them with
  the repo's own bf16 encode kernels, whose codes differ from the exact
  ones only at near ties. Cosine and Manhattan ignore ``precision`` and
  are plain PyTorch on every device.
* ADC sums: :meth:`ProductQuantizer.adc_distances`, the chunked scan and
  cosine's reconstruction norms sum table entries with K8
  (:func:`adc_lookup_fused`).
* search: :meth:`ProductQuantizer.adc_search` takes the fused route (K5
  plus one stable merge) whenever the kernel's contract holds — metric in
  {squared_euclidean, euclidean, manhattan}, k <= 256,
  ``1 <= fetch <= 128`` and ``fetch < n``. The JAX package adds TPU
  budget gates (backend, VMEM, ``n > 32768``); they are not ported, and
  the results do not depend on them, because the fused route returns the
  same ids and bit-identical distances as the dense and chunked scans.
  Otherwise corpora longer than ``chunk`` take the chunked scan, and the
  rest the dense ``[Q, n]`` scan.

Every function follows its input tensor's device (non-tensor input goes
to the card unless a ``device`` is given); fp32 products run in full fp32
(the package turns TF32 off on import).
"""

from __future__ import annotations

from typing import Optional

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import (
    Quantizer,
    as_batch_compute,
    as_batch_f32,
    as_tensor,
    check_training_matrix,
    resolve_device,
)
from vq_tpu_torch.ops.cuda_kernels import (
    TOP_LANES,
    adc_lookup_fused,
    adc_scan_topk_fused,
    int_argmin,
    pq_encode_fused,
)
from vq_tpu_torch.ops.distance import COSINE_NORM_EPS, _PAIRWISE, Metric
from vq_tpu_torch.ops.kmeans import (
    CONVERGENCE_EPS,
    _pq_lloyd_fused,
    _validate_kmeans_args,
    default_block_rows,
)
from vq_tpu_torch.ops.packing import unpack_codes

__all__ = ["ProductQuantizer", "pq_train", "pq_encode", "pq_decode"]

_L2 = (Metric.SQUARED_EUCLIDEAN, Metric.EUCLIDEAN)
_FUSED_METRICS = _L2 + (Metric.MANHATTAN,)
# The JAX package's precision names -> the kernel that computes them.
_ENCODE_PRECISIONS = {"highest": "highest", "high": "bf16x3", "bf16x3": "bf16x3",
                      "default": "bf16_fast", "bf16_fast": "bf16_fast"}


# ---------------------------------------------------------------------------
# Cores.
# ---------------------------------------------------------------------------


def _subspace_scores(xs: torch.Tensor, cb: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Cosine / Manhattan distances ``[n, m, k]`` of ``xs [n, m, s]``."""
    if metric == Metric.COSINE:
        xc = torch.einsum("nms,mks->nmk", xs, cb)
        nx = torch.sqrt((xs * xs).sum(-1))
        nc = torch.sqrt((cb * cb).sum(-1))
        denom = torch.clamp_min(nx[:, :, None] * nc[None], COSINE_NORM_EPS)
        dist = torch.clamp(1.0 - xc / denom, 0.0, 1.0)
        degenerate = (nx[:, :, None] < COSINE_NORM_EPS) | (nc[None] < COSINE_NORM_EPS)
        return torch.where(degenerate, torch.ones_like(dist), dist)
    if metric == Metric.MANHATTAN:
        return (xs[:, :, None, :] - cb[None]).abs().sum(-1)
    raise InvalidParameter("metric", f"unsupported metric {metric}")


def _pq_encode_plain_metric(x, cb, metric: Metric, block_rows: int) -> torch.Tensor:
    m, k, s = cb.shape
    out = torch.empty((x.shape[0], m), dtype=torch.int32, device=x.device)
    for b0 in range(0, x.shape[0], block_rows):
        tile = x[b0:b0 + block_rows].to(torch.float32).reshape(-1, m, s)
        out[b0:b0 + block_rows] = int_argmin(_subspace_scores(tile, cb, metric))[1]
    return out


def _adc_tables(q: torch.Tensor, cb: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Per-query tables ``[Q, m, k]``: per-subspace squared distances (L2
    family), L1 distances (Manhattan) or dots (cosine)."""
    qs = q.reshape(q.shape[0], cb.shape[0], cb.shape[2])
    if metric in _L2:
        xc = torch.einsum("qms,mks->qmk", qs, cb)
        cc = (cb * cb).sum(-1)
        qq = (qs * qs).sum(-1)
        return torch.clamp_min(qq[:, :, None] + cc[None] - 2.0 * xc, 0.0)
    if metric == Metric.MANHATTAN:
        return (qs[:, :, None, :] - cb[None]).abs().sum(-1)
    if metric == Metric.COSINE:
        return torch.einsum("qms,mks->qmk", qs, cb)
    raise InvalidParameter("metric", f"unsupported metric {metric}")


def _adc_lookup(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``sum_i tables[:, i, codes[:, i]]`` -> ``[Q, n]``, added in subspace
    order 0..m-1 from 0.0 (the order every ADC path shares), through K8."""
    return adc_lookup_fused(tables, codes)


def _cosine_from_dots(acc, cb, codes, qn):
    recon_sqn = _adc_lookup((cb * cb).sum(-1)[None], codes)[0]
    rn = torch.sqrt(recon_sqn.clamp_min(0.0))
    denom = torch.clamp_min(qn[:, None] * rn[None, :], COSINE_NORM_EPS)
    dist = torch.clamp(1.0 - acc / denom, 0.0, 1.0)
    degenerate = (qn[:, None] < COSINE_NORM_EPS) | (rn[None, :] < COSINE_NORM_EPS)
    return torch.where(degenerate, torch.ones_like(dist), dist)


def _smallest(d: torch.Tensor, k: int):
    """``(values, positions)`` of the k smallest per row, ascending, the
    lowest position first on exact ties, every NaN last and -0.0 equal to
    +0.0 (``torch.topk`` promises no tie order). A stable sort of the key
    ``d + 0.0``, which turns -0.0 into +0.0 and, on the card, every NaN
    into the canonical +NaN (the card's float add returns it). Sorting the
    values themselves orders them so on the CPU only: the card's radix
    sort puts a NaN with its sign bit set first and -0.0 before +0.0 (the
    CPU's sort takes every NaN as largest, whatever its sign). The values
    returned are the row's own."""
    pos = torch.sort(d + 0.0, dim=1, stable=True)[1][:, :k]
    return torch.gather(d, 1, pos), pos


def _topk_scan(values, n: int, nq: int, fetch: int, chunk: int, device, radius=None):
    """Running top-``fetch`` over ``values(c0, c1) -> [Q, c1 - c0]``
    (smaller is better), one chunk of rows at a time: each chunk is merged
    with the best so far by :func:`_smallest` over ``[best, chunk]``, so
    the working set never grows with n and ``lax.top_k``'s order holds
    (the lowest id first on ties). With a ``radius``, also counts a row's
    values ``<= radius`` in the same pass (``range_search``). Returns
    ``(ids [Q, fetch] i32, values [Q, fetch], hits [Q] i32 or None)``;
    slots no row fills keep id -1 and value +inf."""
    best_d = torch.full((nq, fetch), float("inf"), device=device)
    best_i = torch.full((nq, fetch), -1, dtype=torch.int64, device=device)
    hits = None if radius is None else torch.zeros(nq, dtype=torch.int64, device=device)
    for c0 in range(0, n, chunk):
        d = values(c0, min(c0 + chunk, n))
        if hits is not None:
            hits += (d <= radius).sum(1)
        best_d, pos = _smallest(torch.cat([best_d, d], dim=1), fetch)
        kept = torch.gather(best_i, 1, pos.clamp_max(max(fetch - 1, 0)))
        best_i = torch.where(pos < fetch, kept, pos + (c0 - fetch))
    return best_i.to(torch.int32), best_d, None if hits is None else hits.to(torch.int32)


def _merge_candidates(vals, ids, fetch: int, euclidean: bool = False):
    """Merge K5's per-tile candidates into the top ``fetch`` -> ``(ids,
    values)``. Only the first ``fetch`` lanes of each tile can hold a
    finite value (the rest are inf / -1 padding), so only they are sorted:
    one stable sort, candidates lying in ascending id order within equal
    values. Ids of +inf values become -1; ``euclidean`` takes the sqrt
    after."""
    q, width = vals.shape
    tiles = width // TOP_LANES
    vals = vals.view(q, tiles, TOP_LANES)[..., :fetch].reshape(q, tiles * fetch)
    ids = ids.view(q, tiles, TOP_LANES)[..., :fetch].reshape(q, tiles * fetch)
    dist, pos = _smallest(vals, fetch)
    idx = torch.gather(ids, 1, pos)
    idx = torch.where(torch.isinf(dist), torch.full_like(idx, -1), idx)
    if euclidean:
        dist = torch.sqrt(dist.clamp_min(0.0))
    return idx, dist


def _adc_search_fused(tables, codes, fetch: int, metric: Metric, pack_bits: int = 8):
    """Flat ADC top-``fetch`` through K5 -> ``(ids [Q, fetch] i32, dist)``."""
    codes_t = codes.to(torch.uint8).T.contiguous()  # [m | B, n]
    vals, ids = adc_scan_topk_fused(tables, codes_t, fetch, pack_bits=pack_bits)
    return _merge_candidates(vals, ids, fetch, metric == Metric.EUCLIDEAN)


# ---------------------------------------------------------------------------
# Functional API.
# ---------------------------------------------------------------------------


def pq_train(
    training_data,
    num_subspaces: int,
    num_centroids: int,
    max_iters: int = 10,
    seed: int = 42,
    *,
    init_codebooks=None,
    device=None,
) -> torch.Tensor:
    """Train PQ codebooks; returns ``[m, k, sub_dim]`` f32 on the data's
    device (``device`` moves non-tensor input there)."""
    data = check_training_matrix(training_data, device).contiguous()
    n, dim = data.shape
    m = int(num_subspaces)
    k = int(num_centroids)
    if m <= 0:
        raise InvalidParameter("num_subspaces", "must be greater than 0")
    if dim < m:
        raise InvalidParameter(
            "num_subspaces", f"must be at most the data dimension ({dim})"
        )
    if dim % m != 0:
        raise InvalidParameter(
            "num_subspaces", f"dimension ({dim}) must be divisible by m"
        )
    _validate_kmeans_args(n, k, int(max_iters))
    init = None
    if init_codebooks is not None:
        init = as_tensor(init_codebooks, data.device).to(torch.float32)
        if tuple(init.shape) != (m, k, dim // m):
            raise InvalidParameter(
                "init_centroids",
                f"expected {(m, k, dim // m)}, got {tuple(init.shape)}",
            )
    codebooks, _iters, _conv = _pq_lloyd_fused(
        data, k, m, int(max_iters), float(CONVERGENCE_EPS), int(seed), init
    )
    return codebooks


def pq_encode(
    x, codebooks, metric: Metric | str = Metric.EUCLIDEAN,
    block_rows: Optional[int] = None, precision: str = "highest",
) -> torch.Tensor:
    """Encode ``[n, d]`` vectors to ``[n, m]`` int32 code indices, on
    ``x``'s device. ``precision`` (L2 metrics): ``"highest"`` exact f32;
    ``"high"`` / ``"bf16x3"`` three bf16 passes; ``"default"`` /
    ``"bf16_fast"`` one bf16 pass (codes differ from exact ones at near
    ties only)."""
    metric = Metric.parse(metric)
    x2d, _ = as_batch_compute(x)
    cb = as_tensor(codebooks, x2d.device).to(torch.float32)
    m, k, s = cb.shape
    if x2d.shape[1] != m * s:
        raise DimensionMismatch(expected=m * s, found=x2d.shape[1])
    if precision not in _ENCODE_PRECISIONS:
        raise InvalidParameter(
            "precision", f"must be one of {sorted(_ENCODE_PRECISIONS)}"
        )
    if metric in _L2:
        return pq_encode_fused(x2d, cb, _ENCODE_PRECISIONS[precision])
    if block_rows is None:
        block_rows = default_block_rows(x2d.shape[0], k * m, s)
    return _pq_encode_plain_metric(x2d, cb, metric, int(block_rows))


def pq_decode(codes, codebooks) -> torch.Tensor:
    """Decode ``[n, m]`` code indices to ``[n, d]`` f32 centroid values (a
    plain gather; the JAX package's one-hot matmul dodged a TPU lowering)."""
    codes = as_tensor(codes)
    cb = as_tensor(codebooks, codes.device).to(torch.float32)
    if codes.ndim == 1:
        codes = codes[None, :]
    if codes.shape[1] != cb.shape[0]:
        raise DimensionMismatch(expected=cb.shape[0], found=codes.shape[1])
    lanes = torch.arange(cb.shape[0], device=cb.device)
    picked = cb[lanes[None, :], codes.to(torch.int64)]  # [n, m, s]
    return picked.reshape(codes.shape[0], -1)


# ---------------------------------------------------------------------------
# ProductQuantizer.
# ---------------------------------------------------------------------------


class ProductQuantizer(Quantizer):
    """Product quantizer with m sub-codebooks.

    ``ProductQuantizer(training_data, num_subspaces, num_centroids,
    max_iters=10, distance=None, seed=42, *, codebooks=None, device=None)``
    — the JAX package's signature plus ``device``: the codebooks live
    there (by default, on the device of the tensor given), and every
    method moves its input there.
    """

    def __init__(
        self,
        training_data=None,
        num_subspaces: int = None,
        num_centroids: int = None,
        max_iters: int = 10,
        distance=None,
        seed: int = 42,
        *,
        codebooks=None,
        device=None,
    ):
        self._metric = Metric.parse(getattr(distance, "metric", distance))
        self._device = resolve_device(device, codebooks, training_data)
        if codebooks is not None:
            cb = as_tensor(codebooks, self._device).to(torch.float32)
            if cb.ndim != 3:
                raise InvalidParameter(
                    "codebooks", f"must be [m, k, sub_dim], got {cb.ndim}-D"
                )
            self._codebooks = cb.contiguous()
        else:
            if training_data is None:
                raise InvalidParameter(
                    "training_data", "required when codebooks are not given"
                )
            if num_subspaces is None or num_centroids is None:
                raise InvalidParameter(
                    "num_subspaces/num_centroids",
                    "required when training from data",
                )
            self._codebooks = pq_train(
                training_data, num_subspaces, num_centroids,
                max_iters=max_iters, seed=seed, device=self._device,
            )

    @property
    def codebooks(self) -> torch.Tensor:
        """Trained codebooks, ``[m, k, sub_dim]`` f32."""
        return self._codebooks

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_subspaces(self) -> int:
        return self._codebooks.shape[0]

    @property
    def num_centroids(self) -> int:
        return self._codebooks.shape[1]

    @property
    def sub_dim(self) -> int:
        return self._codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.num_subspaces * self.sub_dim

    @property
    def distance_metric(self) -> str:
        return self._metric.value

    # -- code-index API ------------------------------------------------------

    def encode(self, x, precision: str = "highest") -> torch.Tensor:
        """``[n, d]`` (or ``[d]``) -> ``[n, m]`` (or ``[m]``) code indices,
        uint8 when k <= 256. f16/bf16 input stays half."""
        x2d, was_1d = as_batch_compute(x, self._device)
        codes = pq_encode(x2d, self._codebooks, self._metric, precision=precision)
        if self.num_centroids <= 256:
            codes = codes.to(torch.uint8)
        return codes[0] if was_1d else codes

    def decode(self, codes) -> torch.Tensor:
        """Inverse of :meth:`encode` -> f32 reconstruction ``[n, d]``."""
        codes = as_tensor(codes, self._device)
        out = pq_decode(codes, self._codebooks)
        return out[0] if codes.ndim == 1 else out

    def quantize(self, x) -> torch.Tensor:
        """The selected centroids' values as f16 (``[d]`` or ``[n, d]``)."""
        x2d, was_1d = as_batch_f32(x, self._device)
        if x2d.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x2d.shape[1])
        recon = self.decode(self.encode(x2d)).to(torch.float16)
        return recon[0] if was_1d else recon

    def dequantize(self, quantized) -> torch.Tensor:
        """f16 -> f32 cast with a dim check."""
        q = as_tensor(quantized, self._device)
        d = q.shape[-1] if q.ndim else 0
        if d != self.dim:
            raise DimensionMismatch(expected=self.dim, found=d)
        return q.to(torch.float32)

    # -- ADC search ----------------------------------------------------------

    def _queries(self, queries) -> torch.Tensor:
        q2d, _ = as_batch_f32(queries, self._device)
        if q2d.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=q2d.shape[1])
        return q2d

    def adc_tables(self, queries) -> torch.Tensor:
        """Per-query lookup tables ``[Q, m, k]`` under this PQ's metric."""
        return _adc_tables(self._queries(queries), self._codebooks, self._metric)

    def _codes(self, codes, pack_bits: int) -> torch.Tensor:
        codes = as_tensor(codes, self._device)
        if codes.ndim == 1:
            codes = codes[None, :]
        if pack_bits < 8:
            codes = unpack_codes(codes, pack_bits, self.num_subspaces)
        return codes

    def adc_distances(self, queries, codes, *, pack_bits: int = 8) -> torch.Tensor:
        """Asymmetric distances ``[Q, n]`` between raw queries and the
        encoded corpus ``codes [n, m]`` (sub-byte packed when
        ``pack_bits < 8``)."""
        q2d = self._queries(queries)
        codes = self._codes(codes, int(pack_bits))
        acc = _adc_lookup(_adc_tables(q2d, self._codebooks, self._metric), codes)
        if self._metric == Metric.EUCLIDEAN:
            return torch.sqrt(acc.clamp_min(0.0))
        if self._metric == Metric.COSINE:
            qn = torch.sqrt((q2d * q2d).sum(-1))
            return _cosine_from_dots(acc, self._codebooks, codes, qn)
        return acc

    def adc_search(self, queries, codes, k: int = 10, *, rerank: int = 0,
                   corpus=None, chunk: int = 262_144, pack_bits: int = 8):
        """Top-k nearest codes for each query by asymmetric distance ->
        ``(indices [Q, k], distances [Q, k])``, ascending, lowest id
        first on exact ties.

        With ``rerank=R > 0`` and the raw ``corpus`` rows, a top-R ADC
        shortlist is re-scored with exact distances under this metric.
        """
        codes_arr = as_tensor(codes, self._device)
        n = codes_arr.shape[0]
        k, rerank, pack_bits = int(k), int(rerank), int(pack_bits)
        fetch = max(k, rerank) if rerank else k
        q2d = self._queries(queries)
        if (self._metric in _FUSED_METRICS and self.num_centroids <= 256
                and 1 <= fetch <= 128 and fetch < n):
            tables = _adc_tables(q2d, self._codebooks, self._metric)
            ids, dist = _adc_search_fused(
                tables, codes_arr, fetch, self._metric, pack_bits
            )
        elif n > int(chunk) and fetch < n:
            ids, dist, _ = self._adc_search_chunked(
                q2d, codes_arr, fetch, int(chunk), pack_bits=pack_bits
            )
        else:
            d = self.adc_distances(q2d, codes_arr, pack_bits=pack_bits)
            if rerank and corpus is not None:
                return self._rerank(q2d, _smallest(d, rerank)[1], corpus, k)
            dist, ids = _smallest(d, k)
            return ids.to(torch.int32), dist
        if rerank and corpus is not None:
            return self._rerank(q2d, ids, corpus, k)
        return ids[:, :k], dist[:, :k]

    def _rerank(self, q2d, short, corpus, k: int):
        """Re-score the shortlist ``short [Q, R]`` exactly; the candidates
        are gathered first and upcast after, so a half-width corpus is
        never copied whole to f32."""
        corpus = as_tensor(corpus, self._device)
        cand = corpus[short.to(torch.int64)].to(torch.float32)  # [Q, R, d]
        pair = _PAIRWISE[self._metric]
        exact = torch.vmap(lambda qv, cv: pair(qv[None, :], cv)[0])(q2d, cand)
        vals, pos = _smallest(exact, min(k, short.shape[1]))
        return torch.gather(short, 1, pos).to(torch.int32), vals

    def _adc_search_chunked(self, q2d, codes, fetch: int, chunk: int, *,
                            pack_bits: int = 8, radius=None):
        """Blockwise ADC scan (K8 a chunk; packed codes unpacked a chunk at
        a time) with a running top-``fetch`` merge: the working set is one
        ``[Q, chunk]`` block, never ``[Q, n]``. Returns ``(ids, values,
        hits)``, ``hits`` the count of values ``<= radius`` a query (None
        without a radius)."""
        tables = _adc_tables(q2d, self._codebooks, self._metric)
        qn = torch.sqrt((q2d * q2d).sum(-1))

        def values(c0, c1):
            block = self._codes(codes[c0:c1], pack_bits)
            acc = _adc_lookup(tables, block)
            if self._metric == Metric.EUCLIDEAN:
                return torch.sqrt(acc.clamp_min(0.0))
            if self._metric == Metric.COSINE:
                return _cosine_from_dots(acc, self._codebooks, block, qn)
            return acc

        return _topk_scan(values, codes.shape[0], q2d.shape[0], fetch, chunk, q2d.device, radius)

    def __repr__(self) -> str:
        return (
            f"ProductQuantizer(m={self.num_subspaces}, k={self.num_centroids}, "
            f"sub_dim={self.sub_dim}, distance={self._metric.value!r}, "
            f"device={str(self._device)!r})"
        )
