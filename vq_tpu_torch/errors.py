"""Error taxonomy for vq_tpu_torch — the same classes and messages as
``vq_tpu.errors``, so code written against either package catches the
same exceptions (every concrete error is also a ``ValueError``)."""

from __future__ import annotations


class VqError(Exception):
    """Base class for all vq_tpu_torch errors."""


class DimensionMismatch(VqError, ValueError):
    """Input dimension differs from the expected dimension."""

    def __init__(self, expected: int, found: int):
        self.expected = int(expected)
        self.found = int(found)
        super().__init__(
            f"dimension mismatch: expected {self.expected}, found {self.found}"
        )


class EmptyInput(VqError, ValueError):
    """An operation received empty input."""

    def __init__(self, message: str = "input must not be empty"):
        super().__init__(message)


class InvalidParameter(VqError, ValueError):
    """A parameter failed validation; the parameter name is kept
    introspectable."""

    def __init__(self, parameter: str, reason: str):
        self.parameter = parameter
        self.reason = reason
        super().__init__(f"invalid parameter '{parameter}': {reason}")


class InvalidData(VqError, ValueError):
    """Input data is invalid."""

    def __init__(self, message: str):
        super().__init__(message)
