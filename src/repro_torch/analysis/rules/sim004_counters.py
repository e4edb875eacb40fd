"""SIM004 — counter integrity (invariant I4 in repro_torch.backend.base).

``BackendStats`` is the measurement instrument the whole performance story
rests on (staged/result byte exactness is asserted by tests and the launch
audit), so its fields may only move inside the accounting helpers: the
flush phases, submit/resolve paths, and the deferred ``tail`` closures.
A stray ``backend.stats.result_bytes += ...`` in an index structure or
workload runner would silently skew the Fig 12/13 reproduction.

Field names are parsed from ``backend/base.py``'s ``BackendStats`` class at
lint time (self-maintaining — adding a field extends the rule).  Classes
that own a *different* stats object (``self.stats = <OtherStats>()`` in
``__init__``, e.g. ``WriteBufferStats``, ``SimStats``) are exempt even
where field names collide.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from ..contracts import PACKAGE_ROOT, ParsedModule, walk_own
from ..findings import Finding

_BACKEND_PREFIX = f"{PACKAGE_ROOT}backend/"
_ALLOWED_EXACT = {"flush", "__init__", "tail"}
_ALLOWED_PREFIXES = ("_flush", "submit_", "resolve_", "_resolve",
                     "_execute", "program_entries")

# Fallback if backend/base.py can't be parsed (e.g. linting a single file
# outside the repo): the field list as of this rule's writing.
_FALLBACK_FIELDS = {
    "searches", "gathers", "lookups", "plans", "flushes", "kernel_launches",
    "staged_pages", "staged_queries", "staged_bytes", "batched_searches",
    "programs", "programs_coalesced", "result_bytes",
}


def _parse_backend_stats_fields(root: Path) -> set[str]:
    base = root / PACKAGE_ROOT / "backend" / "base.py"
    try:
        tree = ast.parse(base.read_text())
    except OSError:
        return set(_FALLBACK_FIELDS)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "BackendStats":
            return {s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)}
    return set(_FALLBACK_FIELDS)


def _owned_stats_classes(tree: ast.Module) -> set[str]:
    """Classes that construct their own (non-BackendStats) stats object."""
    owned: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for fn in node.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name == "__init__"):
                continue
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.value, ast.Call) \
                        and isinstance(stmt.value.func, ast.Name) \
                        and stmt.value.func.id != "BackendStats":
                    for t in stmt.targets:
                        if isinstance(t, ast.Attribute) \
                                and t.attr == "stats":
                            owned.add(node.name)
    return owned


def _allowed(func_name: str) -> bool:
    return func_name in _ALLOWED_EXACT \
        or func_name.startswith(_ALLOWED_PREFIXES)


class Sim004Counters:
    rule_id = "SIM004"
    title = "BackendStats fields mutate only inside accounting helpers"

    def __init__(self):
        self._fields: set[str] | None = None

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.startswith(PACKAGE_ROOT) and rel_path.endswith(".py")

    def _fields_for(self, mod: ParsedModule) -> set[str]:
        if self._fields is None:
            # The repo root is the nearest ancestor of the linted file that
            # holds the package's backend/base.py.
            p = Path(mod.real_path)
            root = p
            for anc in p.parents:
                if (anc / PACKAGE_ROOT / "backend" / "base.py").exists():
                    root = anc
                    break
            self._fields = _parse_backend_stats_fields(root)
        return self._fields

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        fields = self._fields_for(mod)
        in_backend = mod.rel_path.startswith(_BACKEND_PREFIX)
        owned = _owned_stats_classes(mod.tree)

        def visit(node, prefix, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    yield from check_fn(q, child, cls)
                    yield from visit(child, f"{q}.", cls)
                elif isinstance(child, ast.ClassDef):
                    yield from visit(child, f"{prefix}{child.name}.",
                                     child.name)
                else:
                    yield from visit(child, prefix, cls)

        def check_fn(qualname, fn, cls):
            if cls in owned and not in_backend:
                return
            for node in walk_own(fn):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        field = self._stats_field_target(t, fields)
                        if field is None:
                            continue
                        if _allowed(fn.name):
                            continue
                        yield Finding(
                            self.rule_id, mod.rel_path, qualname,
                            f"mutates:{field}", line=node.lineno,
                            message=f"writes BackendStats.{field} outside "
                                    "the accounting helpers (flush/_flush_*/"
                                    "submit_*/resolve_*/tail)")

        yield from visit(mod.tree, "", None)

    @staticmethod
    def _stats_field_target(t: ast.AST, fields: set[str]) -> str | None:
        # X.stats.<field> = / += ...
        if isinstance(t, ast.Attribute) and t.attr in fields \
                and isinstance(t.value, ast.Attribute) \
                and t.value.attr == "stats":
            return t.attr
        # wholesale replacement: X.stats = ... (outside __init__ this
        # resets every counter behind the instrument's back)
        if isinstance(t, ast.Attribute) and t.attr == "stats":
            return "<stats>"
        return None
