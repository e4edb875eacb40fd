"""Reliability tier of the port: so far only the typed errors."""
from .errors import DegradedReadError, UncorrectableReadError, require_clean

__all__ = ["DegradedReadError", "UncorrectableReadError", "require_clean"]
