"""SIM005 — match results must be consumed with their error channel.

The reliability tier (repro_torch.reliability) makes every match response carry
an error channel: ``SearchResponse.open_verdict`` reports the §IV-C2 page
open outcome, ``GatherResponse``/``LookupResponse`` carry ``parity_ok``,
and a page whose outer code failed surfaces as a per-ticket
``UncorrectableReadError``.  A consumer that reads ``bitmap_words`` /
``match_count`` / ``value_slot`` while ignoring all of those treats an
undecodable page as "no matches" — the exact silent-wrong-result class the
tier exists to eliminate (an all-zero bitmap from a dead page reads as a
legitimate miss).

The rule flags any function (own scope, nested defs are their own scope)
outside the plumbing layers that loads one of the match-result attributes
without also referencing the error channel: calling
:func:`repro_torch.reliability.require_clean`, handling/raising
``UncorrectableReadError``, or inspecting ``open_verdict``/``parity_ok``
directly.  The plumbing itself — backends (they *produce* the responses),
kernels, the reliability package, and this analysis package — is exempt.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import PACKAGE_ROOT, ParsedModule, walk_own
from ..findings import Finding

_EXEMPT_PREFIXES = tuple(f"{PACKAGE_ROOT}{d}/" for d in (
    "backend", "analysis", "kernels", "reliability"))

# Attributes whose load marks the function as a match-result consumer.
_CONSUMED = {"bitmap_words", "match_count", "value_slot"}

# Any of these in the same scope marks the error channel as handled.
_MARKER_ATTRS = {"open_verdict", "parity_ok"}
_MARKER_NAMES = {"require_clean", "UncorrectableReadError"}


class Sim005Verdicts:
    rule_id = "SIM005"
    title = "match-result consumers acknowledge the error/verdict channel"

    def applies_to(self, rel_path: str) -> bool:
        if not (rel_path.startswith(PACKAGE_ROOT)
                and rel_path.endswith(".py")):
            return False
        return not rel_path.startswith(_EXEMPT_PREFIXES)

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        for qualname, fn in mod.functions():
            consumed: dict[str, int] = {}
            handled = False
            for node in walk_own(fn):
                if isinstance(node, ast.Attribute):
                    if node.attr in _MARKER_ATTRS:
                        handled = True
                    elif node.attr in _CONSUMED \
                            and isinstance(node.ctx, ast.Load):
                        consumed.setdefault(node.attr, node.lineno)
                elif isinstance(node, ast.Name) \
                        and node.id in _MARKER_NAMES:
                    handled = True
            if consumed and not handled:
                for attr, line in sorted(consumed.items(),
                                         key=lambda kv: kv[1]):
                    yield Finding(
                        self.rule_id, mod.rel_path, qualname,
                        f"consumes:{attr}", line=line,
                        message=f"reads .{attr} without consulting the "
                                "error channel (require_clean / "
                                "UncorrectableReadError / open_verdict / "
                                "parity_ok): an uncorrectable page would "
                                "be consumed as an empty match result")
