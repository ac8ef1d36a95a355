"""Sub-byte PQ code packing — the port of ``vq_tpu.ops.packing``.

``[n, m]`` codes pack into ``[n, ceil(m * nbits / 8)]`` u8 words,
little-endian within each byte (code ``i`` of a row sits in byte
``i // per`` at bit ``(i % per) * nbits``, ``per = 8 // nbits``). The
layout is bit-identical to the JAX package's, so packed corpora and
checkpoints move between the two unchanged.
"""

from __future__ import annotations

import torch

from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import as_tensor

__all__ = ["pack_codes", "unpack_codes", "bits_for"]

_VALID_NBITS = (1, 2, 4, 8)


def bits_for(num_centroids: int) -> int:
    """Smallest supported code width for a codebook of ``k`` centroids."""
    k = int(num_centroids)
    if k < 1:
        raise InvalidParameter("num_centroids", "must be at least 1")
    for nbits in _VALID_NBITS:
        if k <= (1 << nbits):
            return nbits
    raise InvalidParameter(
        "num_centroids", "packing supports at most 256 centroids (8 bits)"
    )


def _check_nbits(nbits: int) -> int:
    if int(nbits) not in _VALID_NBITS:
        raise InvalidParameter("nbits", "must be 1, 2, 4, or 8")
    return int(nbits)


def pack_codes(codes, nbits: int) -> torch.Tensor:
    """Pack ``[n, m]`` code indices into ``[n, ceil(m*nbits/8)]`` u8 words.
    Out-of-range codes are truncated to their low ``nbits`` bits."""
    nbits = _check_nbits(nbits)
    codes = as_tensor(codes)
    if codes.ndim != 2:
        raise InvalidParameter("codes", f"expected [n, m], got {codes.ndim}-D")
    # Through int32: a u8 cast of an i32 code above 255 would be
    # implementation-defined, the & mask is not.
    c = codes.to(torch.int32) & 0xFF
    if nbits == 8:
        return c.to(torch.uint8)
    per = 8 // nbits
    n, m = c.shape
    c = torch.nn.functional.pad(c & ((1 << nbits) - 1), (0, (-m) % per))
    shifts = torch.arange(per, device=c.device, dtype=torch.int32) * nbits
    words = (c.reshape(n, -1, per) << shifts).sum(-1)  # disjoint bits: sum == or
    return words.to(torch.uint8)


def unpack_codes(packed, nbits: int, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> ``[n, m]`` u8 code indices."""
    nbits = _check_nbits(nbits)
    packed = as_tensor(packed)
    if packed.ndim != 2:
        raise InvalidParameter("packed", f"expected [n, B], got {packed.ndim}-D")
    if nbits == 8:
        return packed.to(torch.uint8)
    per = 8 // nbits
    need = -(-int(m) // per)
    if packed.shape[1] != need:
        raise InvalidParameter(
            "packed", f"expected {need} bytes per row for m={m} at "
            f"nbits={nbits}, got {packed.shape[1]}"
        )
    p = packed.to(torch.int32)
    shifts = torch.arange(per, device=p.device, dtype=torch.int32) * nbits
    c = (p[:, :, None] >> shifts) & ((1 << nbits) - 1)
    return c.reshape(p.shape[0], -1)[:, : int(m)].to(torch.uint8)
