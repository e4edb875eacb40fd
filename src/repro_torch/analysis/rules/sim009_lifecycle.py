"""SIM009 — interprocedural ticket lifecycle (invariant I1, v2).

SIM001's original flush-before-result check was syntactic: any
``submit_*`` followed by ``.result()`` without a textual ``flush()`` in
between was flagged, which forced the four eager wrappers in
``backend.base`` (``search()`` = ``submit_search(cmd).result()``) into
``baseline.toml`` as allowlisted false positives.  This rule re-grounds
the check on the dataflow engine:

  * the abstract state is the set of *pending ticket tokens*
    (``<submit-name>@<line>``, starred when the submit sits inside a loop
    or comprehension and therefore stands for *many* tickets);
  * flush-named calls (``flush``/``drain``/``resolve_burst`` and their
    prefixed/suffixed spellings) clear the pending set, as does any call
    whose *call-graph summary* says it may flush (so a helper that
    flushes two frames down is proven clean, not allowlisted);
  * a call whose resolved callees all *leave tickets pending* (again a
    summary) adds a token — the interprocedural case no per-function
    rule could see;
  * ``.result()`` with a **single** straight-line pending ticket is the
    documented immediate mode (``Ticket.result`` auto-flushes) and is
    clean — this proves the four ``baseline.toml`` pins and lets us
    delete them.  ``.result()`` while two or more tickets are pending
    (or one looped token, which stands for many) relies on the
    auto-flush to resolve *other* commands' tickets mid-burst: finding
    ``result-no-flush:<submit-name>``.

``may_flush`` summaries deliberately do not propagate through
``result`` — resolving a burst via the auto-flush is exactly the
anti-pattern being policed, so routing a flush summary through it would
launder the violation.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import ParsedModule, callee_name
from ..dataflow import (Bind, ForwardAnalysis, ProjectIndex, Test,
                        build_cfg, calls_in, is_flush_name,
                        looped_call_ids)
from ..findings import Finding

_EMPTY = frozenset()
_PENDING = "@pending"


def _is_submit(name: str | None) -> bool:
    if not name:
        return False
    base = name.lstrip("_")
    return base == "submit" or base.startswith("submit_")


def _count(tokens: frozenset) -> int:
    """Abstract multiplicity: a starred (looped) token stands for many."""
    return sum(2 if t.endswith("*") else 1 for t in tokens)


class PendingAnalysis(ForwardAnalysis):
    """Pending-ticket set propagation over one function."""

    def __init__(self, fi, view):
        super().__init__(build_cfg(fi.node))
        self.fi = fi
        self.view = view
        self.looped = looped_call_ids(fi.node)
        self.exit_pending: frozenset = _EMPTY

    def init_env(self) -> dict:
        return {_PENDING: _EMPTY}

    def transfer(self, st, env: dict) -> dict:
        env = dict(env)
        if isinstance(st, (Test, Bind, ast.stmt)):
            for call in calls_in(st):
                self._call(call, env)
        return env

    def _call(self, call: ast.Call, env: dict) -> None:
        name = callee_name(call)
        pending = env.get(_PENDING, _EMPTY)
        if is_flush_name(name):
            env[_PENDING] = _EMPTY
            return
        if name == "result":
            if _count(pending) >= 2 and self.report is not None:
                for tok in sorted(pending):
                    submit = tok.split("@", 1)[0]
                    self.report(
                        f"result-no-flush:{submit}", call,
                        f".result() reached with {submit} (and other "
                        "commands) still pending — the auto-flush resolves "
                        "a multi-command burst implicitly; call flush() "
                        "first (I1)")
            env[_PENDING] = _EMPTY       # the auto-flush resolves everything
            return
        if _is_submit(name):
            star = "*" if id(call) in self.looped else ""
            env[_PENDING] = pending | {f"{name}@{call.lineno}{star}"}
            return
        matches = self.view.resolve(name)
        if not matches:
            return
        if any(self.view.may_flush(m) for m in matches):
            env[_PENDING] = _EMPTY
        elif all(self.view.leaves_pending(m) for m in matches):
            star = "*" if id(call) in self.looped else ""
            env[_PENDING] = pending | {f"{name}@{call.lineno}{star}"}

    def block_end(self, block, env: dict) -> None:
        if not block.succs:
            self.exit_pending |= env.get(_PENDING, _EMPTY)


def function_leaves_pending(fi) -> bool:
    """Call-graph summary: can this function return with tickets still
    pending (i.e. it submits without flushing/resolving before exit)?"""
    view = ProjectIndex.get().with_module(fi.module)
    pa = PendingAnalysis(fi, view)
    pa.run()
    return bool(pa.exit_pending)


class Sim009Lifecycle:
    rule_id = "SIM009"
    title = "no implicit multi-command flush via Ticket.result() (I1, v2)"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.endswith(".py")

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        view = ProjectIndex.get().with_module(mod)
        for fi in view._local:
            found: list[Finding] = []

            def report(slug, node, msg, _q=fi.qualname, _out=found):
                _out.append(Finding(self.rule_id, mod.rel_path, _q, slug,
                                    message=msg,
                                    line=getattr(node, "lineno", 0)))
            PendingAnalysis(fi, view).run(report)
            seen: set[str] = set()
            for f in found:
                if f.slug not in seen:
                    seen.add(f.slug)
                    yield f
