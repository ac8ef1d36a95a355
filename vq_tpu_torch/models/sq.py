"""Scalar quantization — the port of ``vq_tpu.models.sq``: a uniform
affine quantizer over ``[min, max]`` with one global range
(:class:`ScalarQuantizer`) or one range a dimension
(:class:`PerDimScalarQuantizer`, the faiss-SQ8 style IVF-SQ uses).

* ``step = (max - min) / (levels - 1)``.
* Encode: clamp to ``[min, max]``, then ``floor((x - min) / step + 0.5)``
  (round half away from zero: the argument is non-negative after the
  clamp; ``torch.round`` rounds half to even and would differ at exact
  midpoints), capped at ``levels - 1``, as u8.
* Decode: ``min + code * step``, with no clamping.
* The constructors validate finite ranges, ``max > min`` and
  ``2 <= levels <= 256``, with the JAX package's error classes and
  messages.

Everything is elementwise fp32 on the input's device (the per-dimension
quantizer keeps its ranges on ``device`` and moves input there).
"""

from __future__ import annotations

import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import Quantizer, _check_numeric, as_tensor, require_finite_scalar

__all__ = ["ScalarQuantizer", "PerDimScalarQuantizer"]


def _quantize(x, lo, hi, step, max_idx: float) -> torch.Tensor:
    idx = torch.floor((torch.minimum(torch.maximum(x, lo), hi) - lo) / step + 0.5)
    return torch.clamp_max(idx, max_idx).to(torch.uint8)


class ScalarQuantizer(Quantizer):
    """Uniform scalar quantizer with one range for every value.

    >>> import torch
    >>> sq = ScalarQuantizer(0.0, 1.0, levels=256)
    >>> sq.quantize(torch.tensor([0.0, 0.25, 1.0])).tolist()
    [0, 64, 255]
    >>> sq.dequantize(torch.tensor([0, 255], dtype=torch.uint8)).tolist()
    [0.0, 1.0]
    """

    def __init__(self, min: float, max: float, levels: int = 256):
        lo = require_finite_scalar(min, "min")
        hi = require_finite_scalar(max, "max")
        if hi <= lo:
            raise InvalidParameter("max", "must be greater than min")
        levels = int(levels)
        if levels < 2:
            raise InvalidParameter("levels", "must be at least 2")
        if levels > 256:
            raise InvalidParameter("levels", "must be no more than 256 to fit in u8")
        self._min, self._max, self._levels = lo, hi, levels
        self._step = (hi - lo) / (levels - 1)

    @property
    def min(self) -> float:
        return self._min

    @property
    def max(self) -> float:
        return self._max

    @property
    def levels(self) -> int:
        return self._levels

    @property
    def step(self) -> float:
        return self._step

    def _scalars(self, device, *values):
        return [torch.tensor(v, dtype=torch.float32, device=device) for v in values]

    def quantize(self, x) -> torch.Tensor:
        """u8 codes of ``x`` (any shape), on its device."""
        x = as_tensor(x)
        _check_numeric(x)
        x = x.to(torch.float32)
        lo, hi, step = self._scalars(x.device, self._min, self._max, self._step)
        return _quantize(x, lo, hi, step, float(self._levels - 1))

    def dequantize(self, codes) -> torch.Tensor:
        """f32 values of u8 ``codes`` (any shape)."""
        c = as_tensor(codes).to(torch.uint8).to(torch.float32)
        lo, step = self._scalars(c.device, self._min, self._step)
        return lo + c * step

    def __repr__(self) -> str:
        return f"ScalarQuantizer(min={self._min}, max={self._max}, levels={self._levels})"


class PerDimScalarQuantizer(Quantizer):
    """Scalar quantizer with one ``[min, max]`` range a dimension, given
    or fitted from data with :meth:`from_data`; the same u8 codes and
    rounding as :class:`ScalarQuantizer`, column by column."""

    def __init__(self, mins, maxs, levels: int = 256, *, device=None):
        lo = as_tensor(mins, device).to(torch.float32)
        hi = as_tensor(maxs, lo.device).to(torch.float32)
        if lo.ndim != 1 or lo.shape != hi.shape:
            raise InvalidParameter("mins/maxs", "must be 1-D arrays of equal length")
        if not bool(torch.isfinite(lo).all() & torch.isfinite(hi).all()):
            raise InvalidParameter("mins/maxs", "must be finite")
        if bool((hi <= lo).any()):
            raise InvalidParameter("maxs", "every max must exceed its min")
        levels = int(levels)
        if not 2 <= levels <= 256:
            raise InvalidParameter("levels", "must be in [2, 256]")
        self._lo, self._hi, self._levels = lo, hi, levels
        # A tensor divisor: on the card, PyTorch divides by a Python number
        # as a product with its reciprocal, which can round one ulp away
        # from the quotient the CPU and the JAX package compute.
        self._step = (hi - lo) / torch.full_like(hi, levels - 1)

    @classmethod
    def from_data(cls, data, levels: int = 256, *, device=None) -> "PerDimScalarQuantizer":
        """Per-dimension ``[min, max]`` of a data sample ``[n, d]``; a
        dimension with zero range gets a tiny symmetric pad (its values
        still decode exactly)."""
        x = as_tensor(data, device).to(torch.float32)
        if x.ndim != 2 or x.shape[0] == 0:
            raise InvalidParameter("data", "expected a non-empty [n, d] matrix")
        lo, hi = x.amin(0), x.amax(0)
        pad = torch.where(hi <= lo, torch.clamp_min(lo.abs() * 1e-6, 1e-6), 0.0)
        return cls(lo - pad, hi + pad, levels)

    @property
    def device(self) -> torch.device:
        return self._lo.device

    @property
    def dim(self) -> int:
        return int(self._lo.shape[0])

    @property
    def mins(self) -> torch.Tensor:
        return self._lo

    @property
    def maxs(self) -> torch.Tensor:
        return self._hi

    @property
    def levels(self) -> int:
        return self._levels

    @property
    def steps(self) -> torch.Tensor:
        return self._step

    def quantize(self, x) -> torch.Tensor:
        """u8 codes of ``x [..., d]``."""
        x = as_tensor(x, self.device).to(torch.float32)
        if x.shape[-1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x.shape[-1])
        return _quantize(x, self._lo, self._hi, self._step, float(self._levels - 1))

    def dequantize(self, codes) -> torch.Tensor:
        """f32 values of u8 ``codes [..., d]``."""
        c = as_tensor(codes, self.device).to(torch.uint8).to(torch.float32)
        return self._lo + c * self._step

    def __repr__(self) -> str:
        return f"PerDimScalarQuantizer(dim={self.dim}, levels={self._levels})"
