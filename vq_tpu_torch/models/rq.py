"""Residual quantization (RQ) — the port of ``vq_tpu.models.rq``: S stages
of k full-width centroids, ``x ≈ sum_s C_s[code_s]``, stage s quantizing
the residual left by the stages before it.

* :func:`rq_train` — Lloyd's k-means (:func:`lloyd`, random-row init, K2
  each iteration, K1 for the final assignment) on the running residual,
  one seeded ``torch.Generator`` a stage (seed ``seed * 1_000_003 + s``,
  the analog of the JAX package's ``fold_in(seed, s)``: the streams
  differ, so seeded runs agree on quality, not on codebooks).
* :func:`rq_encode` — greedy: each stage is K1 (:func:`assign_fused`) on
  the residual, where the JAX package runs an XLA dot and ``argmin``;
  both keep the lowest index on exact ties. ``beam > 1``: beam search
  over stage prefixes in plain PyTorch (fp32 matmuls), the best ``beam``
  prefixes kept by a stable sort, so ties go to the lowest (parent,
  code) position as ``lax.top_k`` takes them (``torch.topk`` promises no
  tie order).
* :func:`rq_decode` — a stage-ordered sum of gathers from 0.0. The JAX
  package's one-hot matmul form only dodged a TPU lowering.
* :func:`rq_refine_joint` — LSQ-style rounds: beam encode, then the exact
  least-squares codebooks for those codes, ``(BᵀB + λI) W = BᵀX`` with
  one-hot Gram blocks accumulated over row tiles and a Cholesky solve.

Every function follows its input tensor's device (non-tensor input goes
to the card unless ``device`` is given).
"""

from __future__ import annotations

from typing import Optional

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import (
    Quantizer,
    as_batch_f32,
    as_tensor,
    check_training_matrix,
    resolve_device,
)
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.ops.cuda_kernels import assign_fused
from vq_tpu_torch.ops.kmeans import lloyd

__all__ = ["ResidualQuantizer", "rq_train", "rq_encode", "rq_decode", "rq_refine_joint"]


def rq_train(training_data, num_stages: int, num_centroids: int, max_iters: int = 10,
             seed: int = 42, *, device=None) -> torch.Tensor:
    """Train stage codebooks; returns ``[S, k, d]`` f32 on the data's
    device."""
    data = check_training_matrix(training_data, device)
    stages, k = int(num_stages), int(num_centroids)
    if stages <= 0:
        raise InvalidParameter("num_stages", "must be greater than 0")
    residual = data
    codebooks = []
    for s in range(stages):
        res = lloyd(residual, k, max_iters=max_iters, seed=int(seed) * 1_000_003 + s)
        codebooks.append(res.centroids)
        residual = residual - res.centroids[res.assignments.to(torch.int64)]
    return torch.stack(codebooks)


def _encode_greedy(x: torch.Tensor, cbs: torch.Tensor) -> torch.Tensor:
    codes = torch.empty((x.shape[0], cbs.shape[0]), dtype=torch.int32, device=x.device)
    residual = x
    for s in range(cbs.shape[0]):
        codes[:, s], _ = assign_fused(residual, cbs[s])
        residual = residual - cbs[s][codes[:, s].to(torch.int64)]
    return codes


def _encode_beam_tile(tile: torch.Tensor, cbs: torch.Tensor, cc: torch.Tensor,
                      beam: int) -> torch.Tensor:
    stages, k, _ = cbs.shape
    t = tile.shape[0]
    xx = (tile * tile).sum(-1, keepdim=True)
    scores0 = xx + cc[0][None, :] - 2.0 * (tile @ cbs[0].T)
    costs, idx0 = _smallest(scores0, beam)  # [T, B]
    codes = torch.zeros((t, beam, stages), dtype=torch.int64, device=tile.device)
    codes[:, :, 0] = idx0
    residuals = tile[:, None, :] - cbs[0][idx0]  # [T, B, d]
    rows = torch.arange(t, device=tile.device)[:, None]
    for s in range(1, stages):
        rc = residuals @ cbs[s].T  # [T, B, k]
        rr = (residuals * residuals).sum(-1)
        scores = rr[:, :, None] + cc[s][None, None, :] - 2.0 * rc
        costs, pick = _smallest(scores.reshape(t, beam * k), beam)
        parent, code = pick // k, pick % k
        codes = codes[rows, parent]
        codes[:, :, s] = code
        residuals = residuals[rows, parent] - cbs[s][code]
    best = _smallest(costs, 1)[1][:, 0]
    return codes[torch.arange(t, device=tile.device), best].to(torch.int32)


def rq_encode(x, codebooks, beam: int = 1, block_rows: int = 4096) -> torch.Tensor:
    """Encode ``[n, d]`` to ``[n, S]`` int32 stage codes on ``x``'s
    device; ``beam > 1`` enables beam search (lower MSE, B*k work a
    stage), over row tiles of ``block_rows``."""
    x2d, _ = as_batch_f32(x)
    cbs = as_tensor(codebooks, x2d.device).to(torch.float32)
    if x2d.shape[1] != cbs.shape[2]:
        raise DimensionMismatch(expected=cbs.shape[2], found=x2d.shape[1])
    beam = int(beam)
    if beam <= 1:
        return _encode_greedy(x2d, cbs)
    beam = min(beam, cbs.shape[1])
    cc = (cbs * cbs).sum(-1)
    block = max(1, min(int(block_rows), x2d.shape[0]))
    out = torch.empty((x2d.shape[0], cbs.shape[0]), dtype=torch.int32, device=x2d.device)
    for b0 in range(0, x2d.shape[0], block):
        out[b0:b0 + block] = _encode_beam_tile(x2d[b0:b0 + block], cbs, cc, beam)
    return out


def rq_decode(codes, codebooks) -> torch.Tensor:
    """Decode ``[n, S]`` stage codes to ``[n, d]`` f32: the picked
    centroids added stage by stage from 0.0."""
    codes = as_tensor(codes)
    cbs = as_tensor(codebooks, codes.device).to(torch.float32)
    if codes.ndim == 1:
        codes = codes[None, :]
    if codes.shape[1] != cbs.shape[0]:
        raise DimensionMismatch(expected=cbs.shape[0], found=codes.shape[1])
    c = codes.to(torch.int64)
    out = torch.zeros((codes.shape[0], cbs.shape[2]), dtype=torch.float32, device=cbs.device)
    for s in range(cbs.shape[0]):
        out = out + cbs[s][c[:, s]]
    return out


def _solve_codebooks(x: torch.Tensor, codes: torch.Tensor, k: int, block_rows: int,
                     ridge: float) -> torch.Tensor:
    """Least-squares codebooks ``[S, k, d]`` for fixed codes: the normal
    equations ``G = BᵀB`` (``[S*k, S*k]`` stage-code co-occurrences) and
    ``H = BᵀX``, accumulated over row tiles with one-hot fp32 matmuls
    (counts exact, sums in a fixed order), then ``(G + λ tr(G)/Sk I) W =
    H`` by Cholesky; λ keeps unused codewords harmless."""
    n, d = x.shape
    stages = codes.shape[1]
    sk = stages * k
    g = torch.zeros((sk, sk), dtype=torch.float32, device=x.device)
    h = torch.zeros((sk, d), dtype=torch.float32, device=x.device)
    offs = torch.arange(stages, device=x.device) * k
    for b0 in range(0, n, block_rows):
        cols = codes[b0:b0 + block_rows].to(torch.int64) + offs  # [T, S]
        oh = torch.zeros((cols.shape[0], sk), dtype=torch.float32, device=x.device)
        oh.scatter_(1, cols, 1.0)
        g = g + oh.T @ oh
        h = h + oh.T @ x[b0:b0 + block_rows]
    lam = ridge * torch.trace(g) / sk + 1e-20
    chol = torch.linalg.cholesky(g + lam * torch.eye(sk, dtype=torch.float32, device=x.device))
    return torch.cholesky_solve(h, chol).reshape(stages, k, d)


def rq_refine_joint(training_data, codebooks, *, iters: int = 3, beam: int = 4,
                    block_rows: int = 1024, ridge: float = 1e-5, device=None) -> torch.Tensor:
    """LSQ-style alternating refinement: each round beam-encodes the data
    with the current codebooks, then replaces every stage codebook by the
    least-squares solution for those codes (never a higher MSE for fixed
    codes)."""
    data = check_training_matrix(training_data, device)
    cbs = as_tensor(codebooks, data.device).to(torch.float32)
    _, k, d = cbs.shape
    if data.shape[1] != d:
        raise DimensionMismatch(expected=d, found=data.shape[1])
    block = min(int(block_rows), data.shape[0])
    for _ in range(int(iters)):
        codes = rq_encode(data, cbs, beam=beam)
        cbs = _solve_codebooks(data, codes, k, block, float(ridge))
    return cbs


class ResidualQuantizer(Quantizer):
    """Additive residual quantizer: ``S`` stages x ``k`` full-d centroids.

    ``ResidualQuantizer(training_data, num_stages, num_centroids,
    max_iters=10, seed=42, *, codebooks=None, joint_iters=0, beam=4,
    device=None)`` — the JAX package's signature plus ``device``: the
    codebooks live there (by default, on the device of the tensor given,
    else the card). ``joint_iters > 0`` follows the stage-wise training
    with that many :func:`rq_refine_joint` rounds at ``beam``.
    """

    def __init__(self, training_data=None, num_stages: Optional[int] = None,
                 num_centroids: Optional[int] = None, max_iters: int = 10, seed: int = 42,
                 *, codebooks=None, joint_iters: int = 0, beam: int = 4, device=None):
        self._device = resolve_device(device, codebooks, training_data)
        if codebooks is not None:
            cbs = as_tensor(codebooks, self._device).to(torch.float32)
            if cbs.ndim != 3:
                raise InvalidParameter("codebooks", f"must be [S, k, d], got {cbs.ndim}-D")
            self._cbs = cbs.contiguous()
            return
        if training_data is None or num_stages is None or num_centroids is None:
            raise InvalidParameter(
                "training_data",
                "required (with num_stages/num_centroids) unless codebooks are given",
            )
        self._cbs = rq_train(training_data, num_stages, num_centroids, max_iters=max_iters,
                             seed=seed, device=self._device)
        if int(joint_iters) > 0:
            self._cbs = rq_refine_joint(training_data, self._cbs, iters=int(joint_iters),
                                        beam=int(beam), device=self._device)

    @property
    def codebooks(self) -> torch.Tensor:
        """Stage codebooks, ``[S, k, d]`` f32."""
        return self._cbs

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_stages(self) -> int:
        return self._cbs.shape[0]

    @property
    def num_centroids(self) -> int:
        return self._cbs.shape[1]

    @property
    def dim(self) -> int:
        return self._cbs.shape[2]

    def encode(self, x, beam: int = 1) -> torch.Tensor:
        """``[n, d]`` (or ``[d]``) -> ``[n, S]`` (or ``[S]``) stage codes,
        uint8 when k <= 256; ``beam > 1`` uses beam search."""
        x2d, was_1d = as_batch_f32(x, self._device)
        codes = rq_encode(x2d, self._cbs, beam=beam)
        if self.num_centroids <= 256:
            codes = codes.to(torch.uint8)
        return codes[0] if was_1d else codes

    def decode(self, codes) -> torch.Tensor:
        """Inverse of :meth:`encode` -> f32 reconstruction."""
        codes = as_tensor(codes, self._device)
        out = rq_decode(codes, self._cbs)
        return out[0] if codes.ndim == 1 else out

    def quantize(self, x) -> torch.Tensor:
        """The reconstruction as f16 (``[d]`` or ``[n, d]``)."""
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

    def __repr__(self) -> str:
        return (f"ResidualQuantizer(stages={self.num_stages}, k={self.num_centroids}, "
                f"dim={self.dim})")
