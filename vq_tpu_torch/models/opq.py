"""OPQ, optimized product quantization (Ge et al. 2013) — the port
of ``vq_tpu.models.opq``.

A learned orthogonal rotation ``R`` spreads variance (and correlation)
evenly across the subspaces before PQ; reconstruction rotates back.
:func:`opq_train` alternates, for ``opq_iters`` rounds:

1. the PQ step — :func:`pq_train` on ``X @ R`` (K3 on the card),
   warm-started from the previous round's codebooks;
2. the rotation step — orthogonal Procrustes: with ``Y`` the PQ
   reconstruction of ``X @ R`` (K4's exact encode, then a gather), ``R =
   U @ Vt`` from the SVD of ``X^T Y``.

then polishes the codebooks under the final rotation. The ``[d, d]``
product and SVD are fp32 library calls here, as they are XLA calls
outside any Pallas kernel in the JAX package; ``X @ R`` runs in full
fp32 (TF32 is off package-wide). Seeded training draws from the port's
generators, so it agrees with the JAX package on reconstruction MSE;
restored from arrays, the two encode the same codes.

:class:`OPQQuantizer` wraps the result with the quantizer surface
(encode / decode / quantize / dequantize) and ADC search in the rotated
space: queries (and a rerank corpus) rotate, codes do not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import Quantizer, as_batch_f32, as_tensor, check_training_matrix
from vq_tpu_torch.models.pq import ProductQuantizer, pq_decode, pq_encode, pq_train

__all__ = ["OPQQuantizer", "opq_train"]


def _procrustes(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``argmin_R ||x @ R - y||_F`` over orthogonal ``R``: ``U @ Vt`` of
    the SVD of ``x^T y`` (fp32)."""
    u, _, vt = torch.linalg.svd(x.T @ y, full_matrices=False)
    return u @ vt


def opq_train(
    training_data,
    num_subspaces: int,
    num_centroids: int,
    *,
    opq_iters: int = 10,
    pq_iters: int = 4,
    final_pq_iters: int = 10,
    seed: int = 42,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learn ``(rotation [d, d], codebooks [m, k, sub])`` on the data's
    device: ``pq_iters`` warm-started Lloyd iterations an OPQ round, then
    ``final_pq_iters`` under the final rotation."""
    x = check_training_matrix(training_data, device)
    d = x.shape[1]
    m, k = int(num_subspaces), int(num_centroids)
    if m <= 0 or d % m != 0:
        raise InvalidParameter("num_subspaces", f"dimension ({d}) must be divisible by m")
    rot = torch.eye(d, dtype=torch.float32, device=x.device)
    codebooks = None
    for _ in range(int(opq_iters)):
        xr = x @ rot
        codebooks = pq_train(xr, m, k, max_iters=int(pq_iters), seed=seed,
                             init_codebooks=codebooks)
        y = pq_decode(pq_encode(xr, codebooks, "squared_euclidean"), codebooks)
        rot = _procrustes(x, y)
    codebooks = pq_train(x @ rot, m, k, max_iters=int(final_pq_iters), seed=seed,
                         init_codebooks=codebooks)
    return rot, codebooks


class OPQQuantizer(Quantizer):
    """Rotation-optimized product quantizer.

    ``OPQQuantizer(training_data, num_subspaces, num_centroids, ...)``
    trains; ``rotation=`` and ``codebooks=`` restore a saved model. The
    rotation and codebooks live on ``device`` (by default the training
    tensor's, or the card)."""

    def __init__(
        self,
        training_data=None,
        num_subspaces: Optional[int] = None,
        num_centroids: Optional[int] = None,
        *,
        opq_iters: int = 10,
        pq_iters: int = 4,
        seed: int = 42,
        rotation=None,
        codebooks=None,
        device=None,
    ):
        if rotation is not None and codebooks is not None:
            self._pq = ProductQuantizer(codebooks=codebooks, distance="squared_euclidean",
                                        device=device)
            self._rot = as_tensor(rotation, self._pq.device).to(torch.float32)
        else:
            if training_data is None or num_subspaces is None or num_centroids is None:
                raise InvalidParameter(
                    "training_data",
                    "required (with num_subspaces/num_centroids) unless "
                    "rotation+codebooks are given",
                )
            rot, cb = opq_train(training_data, num_subspaces, num_centroids,
                                opq_iters=opq_iters, pq_iters=pq_iters, seed=seed, device=device)
            self._rot = rot
            self._pq = ProductQuantizer(codebooks=cb, distance="squared_euclidean")

    @property
    def rotation(self) -> torch.Tensor:
        return self._rot

    @property
    def codebooks(self) -> torch.Tensor:
        return self._pq.codebooks

    @property
    def device(self) -> torch.device:
        return self._pq.device

    @property
    def num_subspaces(self) -> int:
        return self._pq.num_subspaces

    @property
    def num_centroids(self) -> int:
        return self._pq.num_centroids

    @property
    def dim(self) -> int:
        return self._pq.dim

    def _rows(self, x) -> Tuple[torch.Tensor, bool]:
        x2d, was_1d = as_batch_f32(x, self.device)
        if x2d.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x2d.shape[1])
        return x2d, was_1d

    def encode(self, x) -> torch.Tensor:
        """PQ codes of ``x @ R`` (u8 when k <= 256; K4 on the card)."""
        x2d, was_1d = self._rows(x)
        codes = self._pq.encode(x2d @ self._rot)
        return codes[0] if was_1d else codes

    def decode(self, codes) -> torch.Tensor:
        """The PQ reconstruction rotated back: ``decode(codes) @ R^T``."""
        return self._pq.decode(codes) @ self._rot.T

    def quantize(self, x) -> torch.Tensor:
        """f16 reconstruction (the reference's quantizer surface)."""
        x2d, was_1d = self._rows(x)
        recon = self.decode(self.encode(x2d)).to(torch.float16)
        return recon[0] if was_1d else recon

    def dequantize(self, quantized) -> torch.Tensor:
        q = as_tensor(quantized, self.device)
        d = q.shape[-1] if q.ndim else 0
        if d != self.dim:
            raise DimensionMismatch(expected=self.dim, found=d)
        return q.to(torch.float32)

    def adc_search(self, queries, codes, k: int = 10, **kw):
        """ADC search in the rotated space (queries rotate, codes do not);
        the keywords of :meth:`ProductQuantizer.adc_search`, a ``corpus``
        for ``rerank`` rotated the same way."""
        q2d, _ = self._rows(queries)
        if kw.get("corpus") is not None:
            kw = dict(kw)
            kw["corpus"] = as_tensor(kw["corpus"], self.device).to(torch.float32) @ self._rot
        return self._pq.adc_search(q2d @ self._rot, codes, k=k, **kw)

    def __repr__(self) -> str:
        return (
            f"OPQQuantizer(m={self.num_subspaces}, k={self.num_centroids}, "
            f"dim={self.dim}, device={str(self.device)!r})"
        )
