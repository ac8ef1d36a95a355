"""Anisotropic (score-aware) product quantization for maximum-inner-product
search — the port of ``vq_tpu.models.pq_anisotropic``.

With residual ``r = x - recon(codes)`` and unit direction ``x_hat = x /
||x||``, the loss of a point is (Guo et al. 2020, the ScaNN codebook loss)

    L = ||r||^2 + (eta - 1) * (r . x_hat)^2        (eta >= 1)

which up-weights the error that moves every query's score for it; ``eta
= 1`` is plain PQ. The parallel term couples the subspaces, so:

* **Encode** (:func:`pq_encode_anisotropic`) starts from the plain
  per-subspace argmin (K4 through :func:`pq_encode` on the card) and runs
  ``sweeps`` rounds of coordinate descent. For subspace ``j`` the
  candidate score is ``cc - 2 xc + (eta-1) (hc hc - 2 t hc)`` with ``xc =
  x_j . c``, ``hc = xc / ||x||`` and ``t = r . x_hat`` less block ``j``'s
  part, carried from subspace to subspace; one ``[B, k]`` fp32 product a
  subspace and row block. Zero-norm rows have ``1 / ||x|| = 0`` and fall
  back to plain L2.
* **Refine** (:func:`pq_refine_anisotropic`) alternates encode sweeps with
  exact codebook updates: entry ``(j, c)`` solves ``(N I + (eta-1) sum h
  h^T + ridge I) c = sum x_j + (eta-1) sum t h`` over its rows. The sums
  are one-hot fp32 products over row blocks, added in block order (no
  float atomics, so the same bits on a second run on the card), and the
  ``k`` systems of a subspace one batched Cholesky solve; the
  factorizations' status is read once, at the end. Empty entries keep
  their centroid.
* **MIPS search** (:func:`mips_adc_search`) builds per-query dot tables
  ``[Q, m, k]`` and takes K5 in mode ``"dot"`` (``-sum``) with one stable
  merge whenever its contract holds (k <= 256 centroids, 1 <= top-k <=
  128); other shapes take the chunked scan of ``models/pq.py`` (K8 a
  chunk). Scores come back descending, the lowest id first on equal
  scores, ``-1`` / ``-inf`` padding.

The JAX package computes the sweeps, sums and solves with XLA products,
not Pallas kernels, so here they are plain PyTorch on every device. Its
encode argmin (``jnp.argmin``) lets a NaN score win; the port's ``int2``
rule never does (``ROADMAP.md``, R1). Its merge (``lax.top_k`` on scores)
ranks +0.0 above -0.0 and lets a positive NaN win; the port keeps
:func:`~vq_tpu_torch.models.pq._smallest`'s order: -0.0 equals +0.0 and
NaN never wins (R8).
"""

from __future__ import annotations

from typing import Optional

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_batch_f32, as_tensor, check_training_matrix, resolve_device
from vq_tpu_torch.models.pq import (
    ProductQuantizer,
    _adc_lookup,
    _merge_candidates,
    _topk_scan,
    pq_encode,
    pq_train,
)
from vq_tpu_torch.ops.cuda_kernels import TOP_LANES, adc_scan_topk_fused, int_argmin
from vq_tpu_torch.ops.kmeans_anisotropic import _eta_minus_one, _f32, anisotropic_eta

__all__ = [
    "AnisotropicProductQuantizer",
    "pq_encode_anisotropic",
    "pq_refine_anisotropic",
    "pq_train_anisotropic",
    "anisotropic_pq_loss",
    "mips_adc_search",
]

# Rows a block of the sweeps, sums and loss: bounds the [B, k] scores and
# the [B, s^2] outer products, as in the JAX package.
_DEFAULT_CHUNK = 65_536


def _check_eta(eta: float) -> float:
    eta = float(eta)
    if eta < 1.0:
        raise InvalidParameter("eta", "must be >= 1 (1 = plain PQ)")
    return eta


def _inv_norms(x2d: torch.Tensor) -> torch.Tensor:
    """``1 / ||x||`` a row, 0 for zero rows."""
    norms = torch.sqrt((x2d * x2d).sum(-1))
    return torch.where(norms > 0, 1.0 / norms.clamp_min(1e-20), 0.0)


def _recon(cb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    m = cb.shape[0]
    return cb[torch.arange(m, device=cb.device)[None, :], codes.to(torch.int64)]


def _init_T(xs, inv, codes, cb, chunk: int) -> torch.Tensor:
    """``T = (x - recon) . x_hat`` a row, blockwise."""
    n = xs.shape[0]
    T = torch.empty((n,), dtype=torch.float32, device=xs.device)
    for b0 in range(0, n, chunk):
        xb = xs[b0:b0 + chunk]
        r = (xb - _recon(cb, codes[b0:b0 + chunk])).reshape(xb.shape[0], -1)
        T[b0:b0 + chunk] = (r * (xb.reshape(xb.shape[0], -1) * inv[b0:b0 + chunk, None])).sum(-1)
    return T


def _encode_block(cb, em1: float, xb, inv_b, codes_b, T_b):
    """One coordinate-descent sweep over all m subspaces of a row block
    (``codes_b`` updated in place) -> the new ``T_b``."""
    for j in range(cb.shape[0]):
        cbj = cb[j]
        hj = xb[:, j] * inv_b[:, None]
        t = T_b + (cbj[codes_b[:, j].to(torch.int64)] * hj).sum(-1)
        xc = xb[:, j] @ cbj.T
        hc = xc * inv_b[:, None]
        cc = (cbj * cbj).sum(-1)
        score = cc[None, :] - 2.0 * xc + em1 * (hc * hc - 2.0 * t[:, None] * hc)
        new = int_argmin(score)[1]
        T_b = t - (cbj[new.to(torch.int64)] * hj).sum(-1)
        codes_b[:, j] = new
    return T_b


def _encode_pass(cb, em1: float, xs, inv, codes, T, chunk: int) -> None:
    for b0 in range(0, xs.shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        T[sl] = _encode_block(cb, em1, xs[sl], inv[sl], codes[sl], T[sl])


def _codebook_pass(cb, em1: float, ridge: float, xs, inv, codes, T, chunk: int):
    """Exact per-entry least-squares update of every subspace in turn
    (``cb`` and ``T`` updated in place) -> a bool tensor, true where a
    factorization failed."""
    m, k, s = cb.shape
    dev = xs.device
    eye = torch.eye(s, dtype=torch.float32, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    n = xs.shape[0]
    for j in range(m):
        cbj = cb[j].clone()
        A = torch.zeros((k, s * s), dtype=torch.float32, device=dev)
        b = torch.zeros((k, s), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        for b0 in range(0, n, chunk):
            sl = slice(b0, b0 + chunk)
            xj = xs[sl, j]
            hj = xj * inv[sl, None]
            cj = codes[sl, j].to(torch.int64)
            t = T[sl] + (cbj[cj] * hj).sum(-1)
            onehot = torch.nn.functional.one_hot(cj, k).to(torch.float32)
            A = A + onehot.T @ (hj[:, :, None] * hj[:, None, :]).reshape(-1, s * s)
            b = b + onehot.T @ (xj + em1 * t[:, None] * hj)
            counts = counts + onehot.sum(0)
        full = counts[:, None, None] * eye + em1 * A.reshape(k, s, s) + ridge * eye
        chol, info = torch.linalg.cholesky_ex(full)
        failed |= (info != 0).any()
        sol = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
        new_cbj = torch.where((counts > 0)[:, None], sol, cbj)
        cb[j] = new_cbj
        for b0 in range(0, n, chunk):
            sl = slice(b0, b0 + chunk)
            hj = xs[sl, j] * inv[sl, None]
            cj = codes[sl, j].to(torch.int64)
            t = T[sl] + (cbj[cj] * hj).sum(-1)
            T[sl] = t - (new_cbj[cj] * hj).sum(-1)
    return failed


def _loss(xs, inv, codes, cb, em1: float, chunk: int) -> torch.Tensor:
    """The summed objective, added block by block in block order."""
    total = torch.zeros((), dtype=torch.float32, device=xs.device)
    for b0 in range(0, xs.shape[0], chunk):
        xb = xs[b0:b0 + chunk]
        r = (xb - _recon(cb, codes[b0:b0 + chunk])).reshape(xb.shape[0], -1)
        par = (r * xb.reshape(xb.shape[0], -1)).sum(-1) * inv[b0:b0 + chunk]
        total = total + ((r * r).sum(-1) + em1 * par * par).sum()
    return total


def _prep(x2d: torch.Tensor, m: int):
    n, d = x2d.shape
    if d % m != 0:
        raise DimensionMismatch(expected=m, found=d)
    return x2d.reshape(n, m, d // m), _inv_norms(x2d)


def _check_codebooks(x2d, cb):
    m, _, s = cb.shape
    if x2d.shape[1] != m * s:
        raise DimensionMismatch(expected=m * s, found=x2d.shape[1])


def pq_encode_anisotropic(x, codebooks, eta: float, *, sweeps: int = 2, init_codes=None,
                          chunk: int = _DEFAULT_CHUNK, precision: str = "highest") -> torch.Tensor:
    """Encode ``[n, d]`` under the anisotropic loss -> ``[n, m]`` i32 codes
    on ``x``'s device.

    Starts from the plain per-subspace argmin (``init_codes`` overrides;
    otherwise :func:`pq_encode` at ``precision``, K4 on the card at
    ``"highest"``), then ``sweeps`` rounds of coordinate descent. ``eta =
    1`` returns the plain codes exactly; zero-norm rows fall back to L2."""
    x2d, was_1d = as_batch_f32(x)
    cb = as_tensor(codebooks, x2d.device).to(torch.float32)
    m = cb.shape[0]
    _check_codebooks(x2d, cb)
    em1 = _eta_minus_one(_check_eta(eta))
    if init_codes is None:
        init_codes = pq_encode(x2d, cb, "euclidean", precision=precision)
    codes = as_tensor(init_codes, x2d.device).to(torch.int32).reshape(-1, m).clone()
    xs, inv = _prep(x2d, m)
    T = _init_T(xs, inv, codes, cb, int(chunk))
    for _ in range(int(sweeps)):
        _encode_pass(cb, em1, xs, inv, codes, T, int(chunk))
    return codes[0] if was_1d else codes


def pq_refine_anisotropic(data, codebooks, *, eta: Optional[float] = None,
                          threshold: float = 0.2, iters: int = 5, sweeps: int = 1,
                          ridge: float = 1e-6, chunk: int = _DEFAULT_CHUNK, device=None):
    """Refine trained PQ codebooks under the anisotropic loss: ``iters``
    rounds of ``sweeps`` encode sweeps and one exact codebook update,
    then ``sweeps`` final sweeps -> ``(codebooks [m, k, s], codes [n, m]
    i32, loss)``; the loss is non-increasing in ``iters``."""
    x2d = check_training_matrix(data, device)
    cb = as_tensor(codebooks, x2d.device).to(torch.float32).clone()
    m = cb.shape[0]
    _check_codebooks(x2d, cb)
    eta = _check_eta(anisotropic_eta(threshold, x2d.shape[1]) if eta is None else eta)
    em1, ridge, chunk = _eta_minus_one(eta), _f32(ridge), int(chunk)
    codes = pq_encode(x2d, cb, "euclidean")
    xs, inv = _prep(x2d, m)
    T = _init_T(xs, inv, codes, cb, chunk)
    failed = torch.zeros((), dtype=torch.bool, device=x2d.device)
    for _ in range(int(iters)):
        for _ in range(int(sweeps)):
            _encode_pass(cb, em1, xs, inv, codes, T, chunk)
        failed |= _codebook_pass(cb, em1, ridge, xs, inv, codes, T, chunk)
    for _ in range(int(sweeps)):
        _encode_pass(cb, em1, xs, inv, codes, T, chunk)
    if bool(failed):
        raise InvalidData("anisotropic PQ refine: an entry's normal matrix is not positive "
                          "definite (non-finite training data?)")
    return cb, codes, _loss(xs, inv, codes, cb, em1, chunk)


def pq_train_anisotropic(training_data, num_subspaces: int, num_centroids: int,
                         max_iters: int = 10, seed: int = 42, *, eta: Optional[float] = None,
                         threshold: float = 0.2, refine_iters: int = 5, sweeps: int = 1,
                         ridge: float = 1e-6, chunk: int = _DEFAULT_CHUNK,
                         device=None) -> torch.Tensor:
    """Anisotropic PQ codebooks ``[m, k, sub_dim]`` f32: plain PQ training
    (K3 on the card), then :func:`pq_refine_anisotropic`."""
    x = check_training_matrix(training_data, device)
    cb = pq_train(x, num_subspaces, num_centroids, max_iters=max_iters, seed=seed)
    cb, _, _ = pq_refine_anisotropic(x, cb, eta=eta, threshold=threshold, iters=refine_iters,
                                     sweeps=sweeps, ridge=ridge, chunk=chunk)
    return cb


def anisotropic_pq_loss(x, codebooks, codes, eta: float, chunk: int = _DEFAULT_CHUNK) -> float:
    """Summed anisotropic objective of ``codes`` for ``x`` (a diagnostic)."""
    x2d, _ = as_batch_f32(x)
    cb = as_tensor(codebooks, x2d.device).to(torch.float32)
    xs, inv = _prep(x2d, cb.shape[0])
    codes = as_tensor(codes, x2d.device).reshape(x2d.shape[0], -1)
    return float(_loss(xs, inv, codes, cb, _eta_minus_one(eta), int(chunk)))


def mips_adc_search(queries, codebooks, codes, k: int = 10, chunk: int = 262_144):
    """Top-k maximum-inner-product search over an encoded corpus ->
    ``(indices [Q, k] i32, scores [Q, k] f32)``, descending, the lowest id
    first on equal scores; rows with fewer than ``k`` hits pad with ``-1``
    / ``-inf``. Per-query dot tables ``[Q, m, k]`` from one fp32 product;
    K5 in mode ``"dot"`` where its contract holds (k <= 256 centroids, 1
    <= k <= 128), else a running top-k over ``chunk``-row blocks (K8 a
    block), on the device of the first tensor given."""
    dev = resolve_device(None, queries, codes, codebooks)
    cb = as_tensor(codebooks, dev).to(torch.float32)
    m, kk, s = cb.shape
    q2d, _ = as_batch_f32(queries, dev)
    if q2d.shape[1] != m * s:
        raise DimensionMismatch(expected=m * s, found=q2d.shape[1])
    tables = torch.einsum("qms,mks->qmk", q2d.reshape(-1, m, s), cb)
    codes = as_tensor(codes, dev)
    if codes.ndim == 1:
        codes = codes[None, :]
    k = int(k)
    if kk <= 256 and 1 <= k <= TOP_LANES:  # K5, values -score, and one stable merge
        vals, cand = adc_scan_topk_fused(tables, codes.to(torch.uint8).T.contiguous(), k,
                                         mode="dot")
        ids, neg = _merge_candidates(vals, cand, k)
    else:
        ids, neg, _ = _topk_scan(lambda c0, c1: -_adc_lookup(tables, codes[c0:c1]),
                                 codes.shape[0], q2d.shape[0], k, int(chunk), dev)
    if neg.shape[1] < k:  # an empty corpus
        pad = k - neg.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        neg = torch.nn.functional.pad(neg, (0, pad), value=float("inf"))
    ids = torch.where(neg == float("inf"), -1, ids).to(torch.int32)
    return ids, -neg


class AnisotropicProductQuantizer(ProductQuantizer):
    """Product quantizer trained and encoded under the anisotropic loss.

    Construction trains plain PQ (K3 on the card) and refines the
    codebooks score-aware (``refine_iters`` rounds); or pass
    ``codebooks=`` (with ``eta`` or ``threshold``) to restore one.
    :meth:`encode` runs coordinate descent (``eta = 1`` makes both equal
    to :class:`ProductQuantizer`); :meth:`mips_search` is the
    inner-product search, and the inherited L2 ``decode`` / ``adc_search``
    work on the same codes.
    """

    def __init__(self, training_data=None, num_subspaces: int = None,
                 num_centroids: int = None, max_iters: int = 10, seed: int = 42, *,
                 eta: Optional[float] = None, threshold: float = 0.2, refine_iters: int = 5,
                 sweeps: int = 2, ridge: float = 1e-6, codebooks=None, device=None):
        if codebooks is not None:
            super().__init__(distance="euclidean", codebooks=codebooks, device=device)
            if eta is None:
                eta = anisotropic_eta(threshold, self.dim)
        else:
            super().__init__(training_data, num_subspaces, num_centroids, max_iters=max_iters,
                             distance="euclidean", seed=seed, device=device)
            if eta is None:
                eta = anisotropic_eta(threshold, self.dim)
            _check_eta(eta)
            self._codebooks, _, _ = pq_refine_anisotropic(
                training_data, self._codebooks, eta=float(eta), iters=refine_iters, sweeps=1,
                ridge=ridge, device=self._device,
            )
        self._eta = _check_eta(eta)
        self._sweeps = int(sweeps)

    @property
    def eta(self) -> float:
        return self._eta

    def encode(self, x, precision: str = "highest") -> torch.Tensor:
        """Coordinate-descent encode -> code indices, u8 when k <= 256
        (``precision`` sets the initial plain encode)."""
        x2d, was_1d = as_batch_f32(x, self._device)
        codes = pq_encode_anisotropic(x2d, self._codebooks, self._eta, sweeps=self._sweeps,
                                      precision=precision)
        if self.num_centroids <= 256:
            codes = codes.to(torch.uint8)
        return codes[0] if was_1d else codes

    def mips_search(self, queries, codes, k: int = 10, *, chunk: int = 262_144):
        """Top-k inner-product search over ``codes`` (:func:`mips_adc_search`)."""
        return mips_adc_search(as_batch_f32(queries, self._device)[0], self._codebooks,
                               as_tensor(codes, self._device), k=k, chunk=chunk)

    def __repr__(self) -> str:
        return (
            f"AnisotropicProductQuantizer(m={self.num_subspaces}, k={self.num_centroids}, "
            f"sub_dim={self.sub_dim}, eta={self._eta:.3g}, device={str(self._device)!r})"
        )
