"""SIM002 — observer completeness (invariant I2 in repro_torch.backend.base).

The PlaneStore arena only stays coherent because every mutation of a
stored page image notifies the write observers (``SimChip._notify`` /
``SimChipArray._notify_global``), and every arena-plane mutation updates
the dirty/staging bookkeeping.  A mutating method that skips the notify is
exactly the bug class that makes a kernel backend silently match against a
stale image.

Scope is path-keyed (the invariant is about these two files, not the whole
repo):

  * ``core/engine.py`` — methods that assign into ``pages``/``raw`` (or
    mutate them via ``np.<ufunc>.at``) must call a ``_notify*`` in the
    same method;
  * ``backend/planestore.py`` — methods that assign the device planes
    (``_lo``/``_hi``/``_ids``/``_seeds``) must touch the staging
    bookkeeping (``_dirty``/``staged_rows``/``staged_bytes``) in the same
    method.  ``PlaneStore._grow`` is the accepted exception (pinned in
    baseline.toml): growth is a content-preserving device-side copy.

``__init__`` is exempt — observers subscribe to constructed objects, so
construction is not an observable mutation.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import PACKAGE_ROOT, ParsedModule, callee_name, walk_own
from ..findings import Finding

_SCOPES = {
    f"{PACKAGE_ROOT}core/engine.py": {
        "attrs": {"pages", "raw"},
        "notify": {"_notify", "_notify_global"},
    },
    f"{PACKAGE_ROOT}backend/planestore.py": {
        "attrs": {"_lo", "_hi", "_ids", "_seeds"},
        "notify": {"_dirty", "staged_rows", "staged_bytes"},
    },
}


def _attrs_in(node: ast.AST, wanted: set[str]) -> set[str]:
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and n.attr in wanted}


class Sim002Observers:
    rule_id = "SIM002"
    title = "page/plane mutations must notify write observers"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path in _SCOPES

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        scope = _SCOPES[mod.rel_path]
        attrs, notify = scope["attrs"], scope["notify"]
        for qualname, fn in mod.functions():
            if fn.name == "__init__":
                continue
            mutated: dict[str, int] = {}       # attr -> first line
            notified = False
            for node in walk_own(fn):
                targets: list[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                elif isinstance(node, ast.Delete):
                    targets = node.targets
                elif isinstance(node, ast.Call) and callee_name(node) == "at":
                    # in-place ufunc mutation: np.<ufunc>.at(page.raw, ...)
                    for arg in node.args[:1]:
                        for a in _attrs_in(arg, attrs):
                            mutated.setdefault(a, node.lineno)
                for t in targets:
                    for a in _attrs_in(t, attrs):
                        mutated.setdefault(a, node.lineno)
                if isinstance(node, ast.Call) and callee_name(node) in notify:
                    notified = True
                elif isinstance(node, ast.Attribute) and node.attr in notify:
                    notified = True
            if mutated and not notified:
                attrs_hit = ",".join(sorted(mutated))
                yield Finding(
                    self.rule_id, mod.rel_path, qualname,
                    f"mutates:{attrs_hit}", line=min(mutated.values()),
                    message=f"assigns into {attrs_hit} without notifying "
                            f"observers ({'/'.join(sorted(notify))})")
