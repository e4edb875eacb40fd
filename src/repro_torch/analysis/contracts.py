"""AST contract linter: parse modules, dispatch to SIM rules.

The rules are *repo-specific*: they encode the MatchBackend protocol
invariants listed in ``repro_torch.backend.base``'s module docstring
(I1..I6, cited by rule ID) rather than generic style; path-scoped rules
scope by :data:`PACKAGE_ROOT`.  Each rule lives in ``rules/sim00N_*.py``
and implements ``check(mod) -> Iterator[Finding]`` over a
:class:`ParsedModule`; this module owns the shared AST plumbing —
function enumeration with qualnames, own-scope walking that does NOT
descend into nested function bodies (nested defs are separate scopes: a
deferred ``tail`` closure runs after the flush returns, so statements
inside it are not "in" the flush), and the fixture pragma that lets test
fixtures masquerade as in-scope files.

Fixture pragma: a leading comment ``# analysis: pretend-path=<rel path>``
re-homes a file for rule scoping, so known-bad fixtures under
``tests/torch_analysis_fixtures/`` exercise path-scoped rules (SIM002 only
looks at engine.py/planestore.py, SIM003 at flush/ops.py scopes) without
the rules growing test-only configuration.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterator

from .findings import Finding, dedupe_slugs

#: repo-relative directory of the linted package; every rule scopes by it
PACKAGE_ROOT = "src/repro_torch/"

_PRAGMA = re.compile(r"^#\s*analysis:\s*pretend-path=(\S+)\s*$")

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def walk_own(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested scopes.

    Comprehension bodies ARE walked (they execute inline); nested function
    and class bodies are not (they execute later, in their own scope).
    """
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _SCOPE_NODES):
            stack.extend(ast.iter_child_nodes(n))


def callee_name(call: ast.Call) -> str | None:
    """Final name of a call target: ``a.b.c(...)`` -> ``c``, ``f(...)`` -> ``f``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def attr_root(node: ast.AST) -> str | None:
    """Root name of an attribute chain: ``np.bitwise_xor.at`` -> ``np``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@dataclasses.dataclass
class ParsedModule:
    rel_path: str              # scoping path (pragma-overridable), posix
    real_path: str             # where the file actually lives, posix
    tree: ast.Module
    source: str

    def functions(self) -> Iterator[tuple[str, ast.FunctionDef]]:
        """Every def in the module (nested included), with its qualname."""
        def visit(node: ast.AST, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    yield q, child
                    yield from visit(child, f"{q}.")
                elif isinstance(child, ast.ClassDef):
                    yield from visit(child, f"{prefix}{child.name}.")
                else:
                    yield from visit(child, prefix)
        yield from visit(self.tree, "")


def parse_module(path: Path, root: Path) -> ParsedModule:
    source = path.read_text()
    rel = path.relative_to(root).as_posix() if path.is_relative_to(root) \
        else path.as_posix()
    for line in source.splitlines()[:5]:
        m = _PRAGMA.match(line.strip())
        if m:
            rel = m.group(1)
            break
    return ParsedModule(rel_path=rel, real_path=path.as_posix(),
                        tree=ast.parse(source, filename=str(path)),
                        source=source)


def default_rules():
    from .rules import ALL_RULES
    return list(ALL_RULES)


def run_contracts(root: Path, paths: list[Path] | None = None,
                  rules=None) -> list[Finding]:
    """Lint every module under ``paths`` (default: :data:`PACKAGE_ROOT`)."""
    root = Path(root)
    if paths is None:
        paths = [root / PACKAGE_ROOT]
    if rules is None:
        rules = default_rules()
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: list[Finding] = []
    for f in files:
        mod = parse_module(f, root)
        for rule in rules:
            if rule.applies_to(mod.rel_path):
                findings.extend(rule.check(mod))
    return dedupe_slugs(findings)
