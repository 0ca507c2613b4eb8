"""Structured consensus errors: the base class and the input error.

The same codes as the JAX package's taxonomy. ``InputError`` (PYC101)
also subclasses ``ValueError``, so ``except ValueError`` callers keep
working.
"""

from __future__ import annotations

__all__ = ["ConsensusError", "InputError"]


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
