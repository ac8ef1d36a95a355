"""Binary quantization — the port of ``vq_tpu.models.bq``: thresholding,
and sign bits packed 32 to a word with a Hamming distance over the words.

* :class:`BinaryQuantizer`: ``x >= threshold -> high`` else ``low``, as
  u8 (a NaN compares false, so it maps to ``low``); ``dequantize`` maps
  ``code >= high -> float(high)`` else ``float(low)``. Construction
  validates a finite threshold and ``0 <= low < high <= 255``.
* :func:`pack_bits` / :func:`unpack_bits`: bit ``j`` of word ``w`` holds
  element ``w*32 + j``, padding bits zero; words are ``torch.uint32``,
  as in the JAX package and its checkpoints.
* :func:`hamming_distance`: all-pairs popcount of XOR, int32.

PyTorch has no ``<<`` / ``>>`` for ``uint32`` on the CPU and no popcount,
so packing, unpacking and the Hamming count compute on ``int64`` (a word
fits with room to spare) and cast to ``uint32`` only at the edge, which
round-trips exactly; the popcount is a SWAR bit count. BQ has no TPU
kernel: this is plain PyTorch on every device, following the input's.

>>> import torch
>>> words = pack_bits(torch.tensor([[True, False, True] + [False] * 30]))
>>> words.dtype, words.tolist()
(torch.uint32, [[5, 0]])
>>> hamming_distance(words, pack_bits(torch.zeros(2, 33, dtype=torch.bool))).tolist()
[[2, 2]]
"""

from __future__ import annotations

import torch

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import Quantizer, as_batch_f32, as_tensor, require_finite_scalar

__all__ = [
    "BinaryQuantizer",
    "pack_bits",
    "unpack_bits",
    "packed_width",
    "hamming_distance",
]

# int64 cells of one [rows, cols, words] block of the Hamming count, by
# device: on the CPU its two temporaries stay in cache (2 MB each); on the
# card they are large enough that launches are few (128 MB each).
_HAMMING_CELLS = {"cpu": 1 << 18, "cuda": 1 << 24}


class BinaryQuantizer(Quantizer):
    """Threshold quantizer, batch-first: ``quantize`` takes input of any
    shape and returns u8 codes of that shape; ``dequantize`` inverts to
    f32.

    >>> import numpy as np
    >>> bq = BinaryQuantizer(0.5, low=0, high=1)
    >>> bq.quantize(np.array([0.1, 0.5, 0.9], np.float32)).tolist()
    [0, 1, 1]
    >>> bq.dequantize(np.array([0, 1], np.uint8)).tolist()
    [0.0, 1.0]
    """

    def __init__(self, threshold: float, low: int = 0, high: int = 1):
        threshold = require_finite_scalar(threshold, "threshold")
        low, high = int(low), int(high)
        for name, v in (("low", low), ("high", high)):
            if not 0 <= v <= 255:
                raise InvalidParameter(name, "must fit in u8 (0-255)")
        if low >= high:
            raise InvalidParameter("low/high", "low must be less than high")
        self._threshold = threshold
        self._low = low
        self._high = high

    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def low(self) -> int:
        return self._low

    @property
    def high(self) -> int:
        return self._high

    def _above(self, x: torch.Tensor) -> torch.Tensor:
        return x >= torch.tensor(self._threshold, dtype=torch.float32, device=x.device)

    def quantize(self, x) -> torch.Tensor:
        """u8 codes of ``x`` (any shape), on its device."""
        x, _ = as_batch_f32(x, allow_any_rank=True)
        return torch.where(self._above(x), self._high, self._low).to(torch.uint8)

    def dequantize(self, codes) -> torch.Tensor:
        """f32 values of ``codes`` (any shape, cast to u8)."""
        c = as_tensor(codes).to(torch.uint8)
        return torch.where(c >= self._high, float(self._high), float(self._low)).to(torch.float32)

    def quantize_packed(self, x) -> torch.Tensor:
        """Quantize ``[d]`` or ``[n, d]`` and pack the bits into uint32
        words ``[n, ceil(d/32)]``."""
        x, _ = as_batch_f32(x)
        return pack_bits(self._above(x))

    def dequantize_packed(self, packed, dim: int) -> torch.Tensor:
        """f32 ``low`` / ``high`` values ``[n, dim]`` from packed bits."""
        bits = unpack_bits(packed, dim)
        return torch.where(bits, float(self._high), float(self._low)).to(torch.float32)

    def __repr__(self) -> str:
        return (
            f"BinaryQuantizer(threshold={self._threshold}, "
            f"low={self._low}, high={self._high})"
        )


def packed_width(dim: int) -> int:
    """Number of uint32 words needed to hold ``dim`` bits."""
    return (dim + 31) // 32


def _words(packed) -> torch.Tensor:
    """``[n, words]`` uint32 input as int64 (1-D input is one row)."""
    p = as_tensor(packed)
    if p.ndim == 1:
        p = p[None, :]
    if p.dtype == torch.uint32:
        return p.to(torch.int64)
    # Any other integer type holds the words' bit patterns: keep the low 32.
    return p.to(torch.int64) & 0xFFFFFFFF


def pack_bits(bits) -> torch.Tensor:
    """Pack a boolean ``[n, d]`` (or ``[d]``) matrix into ``[n, ceil(d/32)]``
    uint32 words, little-endian within a word, padding bits zero."""
    bits = as_tensor(bits)
    if bits.ndim == 1:
        bits = bits[None, :]
    bits = bits.to(torch.bool)
    n, dim = bits.shape
    words = packed_width(dim)
    if dim != words * 32:
        padded = torch.zeros((n, words * 32), dtype=torch.bool, device=bits.device)
        padded[:, :dim] = bits
        bits = padded
    lanes = bits.view(n, words, 32)
    acc = torch.zeros((n, words), dtype=torch.int64, device=bits.device)
    for j in range(32):
        acc |= lanes[:, :, j].to(torch.int64) << j
    return acc.to(torch.uint32)


def unpack_bits(packed, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[n, words]`` uint32 -> ``[n, dim]``
    bool."""
    p = _words(packed)
    n, words = p.shape
    out = torch.empty((n, words, 32), dtype=torch.bool, device=p.device)
    for j in range(32):
        out[:, :, j] = ((p >> j) & 1).to(torch.bool)
    return out.view(n, words * 32)[:, :dim]


def _popcount_(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit word (SWAR), in place."""
    v -= (v >> 1) & 0x55555555
    t = v & 0x33333333
    v >>= 2
    v &= 0x33333333
    v += t
    v += v >> 4
    v &= 0x0F0F0F0F
    v *= 0x01010101
    v &= 0xFFFFFFFF
    v >>= 24
    return v


def hamming_distance(a, b) -> torch.Tensor:
    """All-pairs Hamming distance between packed codes: ``a [n, words]``
    and ``b [m, words]`` uint32 -> ``[n, m]`` int32 popcount of XOR, on
    ``a``'s device. Computed in blocks of rows and columns, so that the
    ``[n, m, words]`` XOR never exists whole."""
    a = _words(a)
    b = _words(b).to(a.device)
    n, words = a.shape
    m = b.shape[0]
    if b.shape[1] != words:
        raise InvalidParameter("b", f"expected [m, {words}] words, got {tuple(b.shape)}")
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    cells = _HAMMING_CELLS.get(a.device.type, _HAMMING_CELLS["cuda"])
    cols = max(1, min(m, cells // max(words, 1)))
    rows = max(1, cells // max(cols * words, 1))
    for r0 in range(0, n, rows):
        ab = a[r0:r0 + rows, None, :]
        for c0 in range(0, m, cols):
            pops = _popcount_(ab ^ b[None, c0:c0 + cols, :])
            out[r0:r0 + rows, c0:c0 + cols] = pops.sum(-1).to(torch.int32)
    return out
