"""pyvq's compatibility classes over the port — the twin of the ``pyvq``
shim, with the same classes, signatures, dtype contracts and exceptions,
on :mod:`vq_tpu_torch` instead of the JAX package:

* ``BinaryQuantizer(threshold, low=0, high=1)`` — f32 in, u8 out.
* ``ScalarQuantizer(min, max, levels=256)`` — f32 in, u8 out; ``step``.
* ``ProductQuantizer(training_data, num_subspaces, num_centroids,
  max_iters=10, distance=None, seed=42)`` — ``quantize`` returns the
  selected centroids' values as f16, as the reference bindings do; the
  code-index API is on :class:`vq_tpu_torch.ProductQuantizer`.
* ``TSVQ(training_data, max_depth, distance=None)`` — f16 quantize.
* ``Distance`` with its four static factories and ``compute``.
* ``get_simd_backend()`` — the device the port runs on.

Inputs are numpy arrays or tensors; outputs are numpy arrays. The work
runs where the port's entry points run (the card, unless
:func:`vq_tpu_torch.default_device` names another device). Invalid input
raises ``ValueError``: the port's errors subclass it.
"""

from __future__ import annotations

import numpy as np

import vq_tpu_torch
from vq_tpu_torch import Distance, get_simd_backend  # noqa: F401  (re-exports)

__all__ = [
    "BinaryQuantizer",
    "ScalarQuantizer",
    "ProductQuantizer",
    "TSVQ",
    "Distance",
    "get_simd_backend",
]


def _in(x, dtype):
    """Input as a numpy array of ``dtype`` (a tensor leaves its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _np(x, dtype):
    return np.asarray(x.detach().cpu().numpy(), dtype=dtype)


class BinaryQuantizer:
    """Reference-compatible BQ."""

    def __init__(self, threshold: float, low: int = 0, high: int = 1):
        self._q = vq_tpu_torch.BinaryQuantizer(threshold, low, high)

    def quantize(self, values) -> np.ndarray:
        return _np(self._q.quantize(_in(values, np.float32)), np.uint8)

    def dequantize(self, codes) -> np.ndarray:
        return _np(self._q.dequantize(_in(codes, np.uint8)), np.float32)

    @property
    def threshold(self) -> float:
        return self._q.threshold

    @property
    def low(self) -> int:
        return self._q.low

    @property
    def high(self) -> int:
        return self._q.high

    def __repr__(self) -> str:
        return f"BinaryQuantizer(threshold={self.threshold}, low={self.low}, high={self.high})"


class ScalarQuantizer:
    """Reference-compatible SQ."""

    def __init__(self, min: float, max: float, levels: int = 256):
        self._q = vq_tpu_torch.ScalarQuantizer(min, max, levels)

    def quantize(self, values) -> np.ndarray:
        return _np(self._q.quantize(_in(values, np.float32)), np.uint8)

    def dequantize(self, codes) -> np.ndarray:
        return _np(self._q.dequantize(_in(codes, np.uint8)), np.float32)

    @property
    def min(self) -> float:
        return self._q.min

    @property
    def max(self) -> float:
        return self._q.max

    @property
    def levels(self) -> int:
        return self._q.levels

    @property
    def step(self) -> float:
        return self._q.step

    def __repr__(self) -> str:
        return f"ScalarQuantizer(min={self.min}, max={self.max}, levels={self.levels})"


class ProductQuantizer:
    """Reference-compatible PQ: ``quantize`` emits the selected
    centroids' values as float16 (the reference's storage format),
    ``dequantize`` casts back to f32."""

    def __init__(
        self,
        training_data,
        num_subspaces: int,
        num_centroids: int,
        max_iters: int = 10,
        distance=None,
        seed: int = 42,
    ):
        self._q = vq_tpu_torch.ProductQuantizer(
            _in(training_data, np.float32),
            num_subspaces=num_subspaces,
            num_centroids=num_centroids,
            max_iters=max_iters,
            distance=distance,
            seed=seed,
        )

    def quantize(self, vector) -> np.ndarray:
        return _np(self._q.quantize(_in(vector, np.float32)), np.float16)

    def dequantize(self, codes) -> np.ndarray:
        return _np(self._q.dequantize(_in(codes, np.float16)), np.float32)

    @property
    def num_subspaces(self) -> int:
        return self._q.num_subspaces

    @property
    def sub_dim(self) -> int:
        return self._q.sub_dim

    @property
    def dim(self) -> int:
        return self._q.dim

    def __repr__(self) -> str:
        return (f"ProductQuantizer(num_subspaces={self.num_subspaces}, "
                f"sub_dim={self.sub_dim}, dim={self.dim})")


class TSVQ:
    """Reference-compatible TSVQ."""

    def __init__(self, training_data, max_depth: int, distance=None):
        self._q = vq_tpu_torch.TSVQ(_in(training_data, np.float32), max_depth=max_depth,
                                    distance=distance)

    def quantize(self, vector) -> np.ndarray:
        return _np(self._q.quantize(_in(vector, np.float32)), np.float16)

    def dequantize(self, codes) -> np.ndarray:
        return _np(self._q.dequantize(_in(codes, np.float16)), np.float32)

    @property
    def dim(self) -> int:
        return self._q.dim

    def __repr__(self) -> str:
        return f"TSVQ(dim={self.dim}, max_depth={self._q.max_depth})"
