"""SIM001 — ticket discipline (invariant I1 in repro_torch.backend.base).

Every ``submit_*`` call returns a Ticket that someone must resolve.  This
rule keeps the syntactic sub-check that needs no dataflow:

  * ``dropped:<name>`` — a bare expression statement whose value is a
    ``submit_*`` call: the ticket is discarded, so nothing can ever verify
    the command resolved (the bug class fixed in WriteBuffer.flush).

The historical ``result-no-flush`` sub-check (a ``.result()`` not
dominated by a ``flush()``) was line-order-approximate and flagged the
eager wrappers in ``backend.base`` as false positives; it now lives in
SIM009, re-grounded on the dataflow engine's CFGs and call summaries,
which proves those wrappers clean instead of allowlisting them.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import ParsedModule, callee_name, walk_own
from ..findings import Finding


class Sim001Tickets:
    rule_id = "SIM001"
    title = "submit_* tickets are never dropped on the floor"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.endswith(".py")

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        for qualname, fn in mod.functions():
            for node in walk_own(fn):
                if isinstance(node, ast.Expr) and isinstance(node.value,
                                                             ast.Call):
                    name = callee_name(node.value)
                    if name and name.startswith("submit_"):
                        yield Finding(
                            self.rule_id, mod.rel_path, qualname,
                            f"dropped:{name}", line=node.lineno,
                            message=f"return value of {name}() is "
                                    "discarded; the ticket can never be "
                                    "verified resolved")
