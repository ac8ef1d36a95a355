"""Quantizer interface and input coercion — the port of
``vq_tpu.models.base``.

Every helper follows the input's device: a tensor stays where it is, and
anything else (numpy arrays, lists) lands on ``device``. With no
``device``, it lands on the card (:func:`resolve_device`): the port's entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, CPU
tensors, or sets another default with :func:`default_device`. Where there
is no card and nothing asked for the CPU, they raise; nothing falls back.
"""

from __future__ import annotations

import abc
import contextlib
from typing import Optional

import numpy as np
import torch

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidParameter

_HALF_DTYPES = (torch.float16, torch.bfloat16)
_DEFAULT_DEVICE: Optional[torch.device] = None  # set by default_device()


def resolve_device(device=None, *candidates) -> torch.device:
    """The device an entry point works on: ``device`` when given, else the
    device of the first tensor among ``candidates``, else the default —
    ``cuda``, or what :func:`default_device` set. Raises
    :class:`InvalidParameter` when the default is ``cuda`` and there is no
    card."""
    if device is not None:
        return torch.device(device)
    for c in candidates:
        if isinstance(c, torch.Tensor):
            return c.device
    if _DEFAULT_DEVICE is not None:
        return _DEFAULT_DEVICE
    if not torch.cuda.is_available():
        raise InvalidParameter(
            "device", "no CUDA device, and vq_tpu_torch runs on the card by "
            "default: pass device='cpu' or CPU tensors to run on the CPU"
        )
    return torch.device("cuda")


@contextlib.contextmanager
def default_device(device):
    """Within the block, entry points given neither a ``device`` nor a
    tensor work on ``device`` (``None`` restores the card default).

    >>> import numpy as np
    >>> with default_device("cpu"):
    ...     as_tensor(np.zeros(3, np.float32)).device
    device(type='cpu')
    """
    global _DEFAULT_DEVICE
    saved = _DEFAULT_DEVICE
    _DEFAULT_DEVICE = None if device is None else torch.device(device)
    try:
        yield
    finally:
        _DEFAULT_DEVICE = saved


class Quantizer(abc.ABC):
    """Abstract quantizer: ``quantize`` to a compact representation and
    ``dequantize`` back to f32."""

    @abc.abstractmethod
    def quantize(self, x):
        """Quantize f32 input to this scheme's compact representation."""

    @abc.abstractmethod
    def dequantize(self, q):
        """Reconstruct f32 values from the compact representation."""

    def transform(self, x):
        """The most compact encoding this quantizer has (code indices
        where they exist, else the quantized form)."""
        encode = getattr(self, "encode", None)
        return encode(x) if encode is not None else self.quantize(x)

    def fit_transform(self, x):
        """Encode ``x`` with this (already-fitted) quantizer."""
        return self.transform(x)


def as_tensor(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` as a tensor; an existing tensor moves only when ``device``
    is given, anything else lands on :func:`resolve_device` ``(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiub":
        raise InvalidParameter("x", f"expected numeric input, got dtype {arr.dtype}")
    if not arr.flags.writeable:  # e.g. a view of a JAX array: torch needs its own
        arr = arr.copy()
    return torch.as_tensor(arr, device=resolve_device(device))


def require_finite_scalar(value: float, parameter: str) -> float:
    """``value`` as a float; raise unless it is finite."""
    value = float(value)
    if not np.isfinite(value):
        raise InvalidParameter(parameter, "must be finite (not NaN or infinite)")
    return value


def _check_numeric(x: torch.Tensor) -> None:
    if x.dtype == torch.bool or x.is_complex():
        raise InvalidParameter("x", f"expected numeric input, got dtype {x.dtype}")


def _as_batch(x: torch.Tensor):
    if x.ndim == 1:
        return x[None, :], True
    if x.ndim == 2:
        return x, False
    raise InvalidParameter("x", f"expected [d] or [n, d] input, got {x.ndim}-D")


def as_batch_f32(x, device: Optional[torch.device] = None):
    """Coerce input to an f32 ``[n, d]`` tensor: ``(array_2d, was_1d)``."""
    x = as_tensor(x, device)
    _check_numeric(x)
    return _as_batch(x.to(torch.float32))


def as_batch_compute(x, device: Optional[torch.device] = None):
    """Like :func:`as_batch_f32` but keeps f16/bf16 input half: the
    kernels upcast in registers, so codes equal those of the same values
    given as f32."""
    x = as_tensor(x, device)
    _check_numeric(x)
    if x.dtype not in _HALF_DTYPES:
        x = x.to(torch.float32)
    return _as_batch(x)


def check_training_matrix(data, device: Optional[torch.device] = None) -> torch.Tensor:
    """Validate a 2-D non-empty training matrix, coercing to f32. Ragged
    Python lists raise :class:`DimensionMismatch`."""
    if isinstance(data, (list, tuple)):
        if len(data) == 0:
            raise EmptyInput("training data must not be empty")
        lens = {len(row) for row in data}
        if len(lens) > 1:
            first = len(data[0])
            other = next(n for n in lens if n != first)
            raise DimensionMismatch(expected=first, found=other)
    arr = as_tensor(data, device).to(torch.float32)
    if arr.ndim != 2:
        raise InvalidParameter(
            "training_data", f"must be a 2-D [n, d] matrix, got {arr.ndim}-D"
        )
    if arr.shape[0] == 0 or arr.shape[1] == 0:
        raise EmptyInput("training data must not be empty")
    return arr
