"""SIM003 — no host sync in the hot path (invariant I3 in repro_torch.backend.base).

The lazy result path only buys anything if the flush itself never blocks
on the card: a ``.item()``/``.cpu()``/``tensor_to_words`` on a launch
output, or a ``torch.cuda.synchronize()``, inside ``flush``/``_flush_*``/
``_dispatch*`` (or inside the kernel ``ops.py`` wrappers that run under
the flush) forces the transfer at flush time and serializes burst k+1's
staging behind burst k's kernels.  The host tail belongs in the deferred
``tail`` closures, which is why nested defs are excluded from the hot
scope.

Detection is taint-based: names assigned from device producers (the
kernel wrappers and their chip-axis forms, ``launch_lookups``/
``launch_gathers``, the arena's ``upload_rows``/``upload_rows2d``/
``take``/``take2d``/``arena``, ``words_to_tensor``, anything built by
``torch.*``) hold device tensors; a host-sync construct applied to a
tainted expression is a finding.  ``int()`` on a plain host value in a
flush (e.g. popcounting a numpy command bitmap) is deliberately NOT a
finding, and neither is a ``synchronize`` outside the hot scope.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Iterator

from ..contracts import (PACKAGE_ROOT, ParsedModule, attr_root, callee_name,
                         walk_own)
from ..findings import Finding

_HOT_FILE_GLOBS = (f"{PACKAGE_ROOT}kernels/*/ops.py",)
_HOT_PREFIXES = ("_flush", "_dispatch", "_execute_programs")

_PRODUCERS = {
    "sim_search", "sim_plan", "sim_gather", "sim_fused_lookup", "sim_fused",
    "sim_search_chips", "sim_plan_chips",
    "sim_search_ref", "sim_search_chips_ref", "sim_plan_ref",
    "sim_plan_chips_ref", "sim_gather_ref", "sim_lookup_ref",
    "sim_fused_ref", "launch_lookups", "launch_gathers",
    "upload_rows", "upload_rows2d", "take", "take2d", "arena",
    "words_to_tensor",
}
_SYNC_ALWAYS = {"synchronize"}
_SYNC_TAINTED_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_TAINTED_FUNCS = {"tensor_to_words"}
_COPY_FUNCS = {"asarray", "array", "copy"}     # flagged as np.<f>(tainted)
_CAST_FUNCS = {"int", "float", "bool"}


def _is_hot_file(rel_path: str) -> bool:
    return any(fnmatch.fnmatch(rel_path, g) for g in _HOT_FILE_GLOBS)


def _is_hot_function(name: str, rel_path: str, depth: int) -> bool:
    if _is_hot_file(rel_path):
        return True
    if depth > 0:                  # nested defs are deferred tails, not hot
        return False
    return name == "flush" or name.startswith(_HOT_PREFIXES)


def _is_device_expr(node: ast.AST, tainted: set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in tainted \
                and isinstance(n.ctx, ast.Load):
            return True
        if isinstance(n, ast.Call):
            name = callee_name(n)
            if name in _PRODUCERS:
                return True
            if isinstance(n.func, ast.Attribute) and \
                    attr_root(n.func) == "torch":
                return True
    return False


def _taint(fn: ast.FunctionDef) -> set[str]:
    """Fixpoint over own-scope assignments: which names hold device values."""
    tainted: set[str] = set()
    assigns: list[tuple[list[ast.AST], ast.AST]] = []
    for node in walk_own(fn):
        if isinstance(node, ast.Assign) and node.value is not None:
            assigns.append((node.targets, node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and getattr(node, "value", None) is not None:
            assigns.append(([node.target], node.value))
    for _ in range(len(assigns) + 1):
        changed = False
        for targets, value in assigns:
            if not _is_device_expr(value, tainted):
                continue
            for t in targets:
                for n in ast.walk(t):
                    # "_" is the conventional discard — tainting it would
                    # leak device-ness into unrelated comprehension targets.
                    if isinstance(n, ast.Name) and n.id != "_" \
                            and n.id not in tainted:
                        tainted.add(n.id)
                        changed = True
        if not changed:
            break
    return tainted


class Sim003HostSync:
    rule_id = "SIM003"
    title = "no host synchronization on device values in flush hot paths"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.startswith(PACKAGE_ROOT) and rel_path.endswith(".py")

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        hot: list[tuple[str, ast.FunctionDef]] = []

        def visit(node, prefix, fn_depth):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    if _is_hot_function(child.name, mod.rel_path, fn_depth):
                        hot.append((q, child))
                    visit(child, f"{q}.", fn_depth + 1)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.", fn_depth)
                else:
                    visit(child, prefix, fn_depth)

        visit(mod.tree, "", 0)
        for qualname, fn in hot:
            yield from self._check_function(mod, qualname, fn)

    def _check_function(self, mod, qualname, fn) -> Iterator[Finding]:
        tainted = _taint(fn)
        for node in walk_own(fn):
            if not isinstance(node, ast.Call):
                continue
            name = callee_name(node)
            if name in _SYNC_ALWAYS and isinstance(node.func, ast.Attribute):
                yield self._finding(mod, qualname, name, node.lineno,
                                    f".{name}() blocks on the device")
            elif name in _SYNC_TAINTED_METHODS \
                    and isinstance(node.func, ast.Attribute) \
                    and _is_device_expr(node.func.value, tainted):
                yield self._finding(mod, qualname, name, node.lineno,
                                    f".{name}() forces a device->host "
                                    "transfer at flush time")
            elif name in _SYNC_TAINTED_FUNCS \
                    and any(_is_device_expr(a, tainted) for a in node.args):
                yield self._finding(mod, qualname, name, node.lineno,
                                    f"{name}() copies a device value to "
                                    "the host inside the flush")
            elif name in _COPY_FUNCS and isinstance(node.func, ast.Attribute) \
                    and attr_root(node.func) == "np" \
                    and any(_is_device_expr(a, tainted) for a in node.args):
                yield self._finding(mod, qualname, f"np.{name}", node.lineno,
                                    f"np.{name}() on a device value copies "
                                    "it to host inside the flush")
            elif name in _CAST_FUNCS and isinstance(node.func, ast.Name) \
                    and node.args \
                    and _is_device_expr(node.args[0], tainted):
                yield self._finding(mod, qualname, name, node.lineno,
                                    f"{name}() on a device value is a "
                                    "blocking host sync")

    def _finding(self, mod, qualname, what, line, msg) -> Finding:
        return Finding(self.rule_id, mod.rel_path, qualname,
                       f"host-sync:{what}", line=line,
                       message=msg + " — move it into the deferred tail")
