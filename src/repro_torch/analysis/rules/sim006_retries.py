"""SIM006 — retry loops are bounded and seeded; no silent swallowing.

The device-fault tier (repro_torch.reliability.device_faults, the backend
failover paths, the event frontend's timeout/backoff machinery) lives or
dies on three disciplines:

  * **bounded retry** — every retry loop must terminate: a
    ``while True:`` wrapping a ``try`` with no ``break`` in the loop's
    own body retries a failing command forever, which under a permanent
    outage converts a typed error into a hang.  Bounded forms
    (``for attempt in range(MAX_ATTEMPTS)``, a ``while`` with a real
    condition, or a loop that breaks) are fine;
  * **typed failures** — an ``except`` handler whose body is only
    ``pass`` (or ``...``) silently swallows the error channel; fault
    paths must re-raise, convert to a typed error, or record the outcome.

The historical third sub-check (bare ``default_rng()``) is superseded by
SIM008, which traces RNG entropy to a declared seed through real
dataflow instead of pattern-matching the empty-argument spelling.

Scope: the fault-handling layers only — ``backend/``, ``frontend/`` and
``reliability/`` of the package (``contracts.PACKAGE_ROOT``).  Elsewhere an
infinite poll loop can be legitimate; in these paths it is exactly the
bug the chaos sweep exists to catch.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import PACKAGE_ROOT, ParsedModule, walk_own
from ..findings import Finding

_SCOPED_PREFIXES = tuple(f"{PACKAGE_ROOT}{d}/" for d in (
    "backend", "frontend", "reliability"))
_LOOP_NODES = (ast.While, ast.For)
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _is_true_const(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and test.value is True


def _own_loop_body(loop: ast.While) -> Iterator[ast.AST]:
    """Walk a loop's body without descending into nested loops or scopes
    (a ``break`` there belongs to the inner loop, not this one)."""
    stack = [n for stmt in loop.body for n in [stmt]]
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _LOOP_NODES + _SCOPE_NODES):
            stack.extend(ast.iter_child_nodes(n))


def _swallows_silently(handler: ast.ExceptHandler) -> bool:
    """Handler body is only ``pass`` / bare ``...`` — the error vanishes."""
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) \
                and isinstance(stmt.value, ast.Constant) \
                and stmt.value.value is Ellipsis:
            continue
        return False
    return True


def _handler_name(handler: ast.ExceptHandler) -> str:
    t = handler.type
    if t is None:
        return "bare"
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute):
        return t.attr
    if isinstance(t, ast.Tuple):
        return "+".join(_handler_name(ast.ExceptHandler(type=e))
                        for e in t.elts)
    return "expr"


class Sim006Retries:
    rule_id = "SIM006"
    title = "fault paths retry boundedly, seed their rngs, fail typed"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.startswith(_SCOPED_PREFIXES) \
            and rel_path.endswith(".py")

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        for qualname, fn in mod.functions():
            for node in walk_own(fn):
                # (a) silent exception swallowing
                if isinstance(node, ast.Try):
                    for h in node.handlers:
                        if _swallows_silently(h):
                            yield Finding(
                                self.rule_id, mod.rel_path, qualname,
                                f"swallows:{_handler_name(h)}",
                                line=h.lineno,
                                message="except body is only pass/... — "
                                        "the error vanishes; fault paths "
                                        "must re-raise, convert to a "
                                        "typed error, or record the "
                                        "outcome")
                # (b) unbounded retry: while True wrapping a try, no break
                elif isinstance(node, ast.While) \
                        and _is_true_const(node.test):
                    body = list(_own_loop_body(node))
                    has_try = any(isinstance(n, ast.Try) for n in body)
                    has_break = any(isinstance(n, ast.Break) for n in body)
                    if has_try and not has_break:
                        yield Finding(
                            self.rule_id, mod.rel_path, qualname,
                            "unbounded-retry", line=node.lineno,
                            message="while True around a try with no "
                                    "break: a permanent fault turns a "
                                    "typed error into a hang — bound the "
                                    "attempts (for attempt in "
                                    "range(MAX)) or break on success")
