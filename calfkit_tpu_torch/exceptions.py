"""Exception types the PyTorch serving engine raises.

Own copies of the JAX package's types of the same names: this package
imports nothing of ``calfkit_tpu``.  Only the types this package raises
live here.
"""

from __future__ import annotations

__all__ = ["CalfkitError", "InferenceError"]


class CalfkitError(Exception):
    """Base of every error this package raises."""


class InferenceError(CalfkitError):
    """Local inference backend failure."""
