"""Structured consensus errors: the base class, the input error and the
numerics error.

The same codes as the JAX package's taxonomy. ``InputError`` (PYC101)
also subclasses ``ValueError``, so ``except ValueError`` callers keep
working; ``NumericsError`` (PYC201) subclasses ``ArithmeticError``.
"""

from __future__ import annotations

__all__ = ["ConsensusError", "InputError", "NumericsError"]


class ConsensusError(Exception):
    """Base of the taxonomy. ``error_code`` is stable; ``context`` holds
    machine-readable details (indices, field names)."""

    error_code = "PYC000"

    def __init__(self, message: str = "", **context) -> None:
        super().__init__(message)
        self.context = dict(context)

    def __str__(self) -> str:
        return f"[{self.error_code}] {super().__str__()}"


class InputError(ConsensusError, ValueError):
    """The caller's data is malformed (bad shape, wrong bounds count)."""

    error_code = "PYC101"


class NumericsError(ConsensusError, ArithmeticError):
    """A resolution produced non-finite outputs; the result is refused,
    never returned."""

    error_code = "PYC201"
