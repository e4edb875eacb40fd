"""The typed per-ticket errors the replay catches.

``UncorrectableReadError`` comes from the reliability tier (policy.py),
``DegradedReadError`` from the sharded backend's device-fault path; a
ticket resolves to one of them instead of a wrong response.
"""
from __future__ import annotations

from repro_torch.core.ecc import OpenVerdict


class UncorrectableReadError(RuntimeError):
    """A page's outer code failed after read-retries: the per-ticket error
    surfaced in place of a wrong match result (typed, so callers can count
    it instead of consuming garbage)."""

    def __init__(self, page_addr: int, message: str | None = None):
        self.page_addr = page_addr
        super().__init__(message or
                         f"page {page_addr}: uncorrectable after read-retry "
                         f"(raw error count above the outer-code budget)")


class DegradedReadError(RuntimeError):
    """A page's chip is dead and no replica survives: the typed per-ticket
    error surfaced in place of a wrong (or hung) match result."""

    def __init__(self, page_addr: int, message: str | None = None):
        self.page_addr = page_addr
        super().__init__(message or
                         f"page {page_addr}: chip offline and no live "
                         f"replica (degraded read impossible)")


def require_clean(resp):
    """Acknowledge the verdict channel of a match response.

    Raises :class:`UncorrectableReadError` when the response's page open
    reported UNCORRECTABLE, and returns the response otherwise.
    """
    search = getattr(resp, "search", None)
    verdict = getattr(search if search is not None else resp,
                      "open_verdict", None)
    if verdict == OpenVerdict.UNCORRECTABLE.value:
        raise UncorrectableReadError(-1, "match result consumed from an "
                                         "uncorrectable page open")
    return resp
