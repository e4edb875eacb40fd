"""Accepted-findings allowlist: load/write ``baseline.toml``.

The baseline pins pre-existing, *intentional* violations (e.g.
``PlaneStore._grow`` assigns the arena planes without touching the staging
bookkeeping: growth is a content-preserving device-side copy) so the
``--check`` gate fails only on NEW findings.  Keys are line-number-free (see findings.py), so
edits elsewhere in a pinned file don't churn the baseline.

Parsing prefers ``tomllib`` (3.11+) then ``tomli``; a minimal fallback
parser covers the restricted subset this file actually uses (an
``[[accepted]]`` array of string-valued tables), so the gate runs even on
a bare 3.10 interpreter.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from .findings import Finding

_HEADER = """\
# Accepted findings for `python -m repro_torch.analysis --check`.
#
# Each [[accepted]] entry pins ONE pre-existing, reviewed violation by its
# stable key (rule, path, symbol, slug) — line numbers are deliberately not
# part of the key.  To accept a new finding, append an entry with a reason;
# to regenerate from the current tree, run:
#
#     PYTHONPATH=src python -m repro_torch.analysis --write-baseline
#
# and then restore the reasons in review.  Removing code should remove its
# entry (stale entries are reported as warnings).
"""


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    slug: str
    reason: str = ""

    def key(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.slug)


def _parse_toml(text: str) -> dict:
    try:
        import tomllib
        return tomllib.loads(text)
    except ModuleNotFoundError:
        pass
    try:
        import tomli
        return tomli.loads(text)
    except ModuleNotFoundError:
        return _parse_minimal(text)


_KV = re.compile(r'^([A-Za-z_][\w\-]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def _parse_minimal(text: str) -> dict:
    """Fallback for interpreters without tomllib/tomli: parses only the
    ``[[accepted]]`` + string key/value subset baseline.toml uses."""
    out: dict = {"accepted": []}
    cur: dict | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[accepted]]":
            cur = {}
            out["accepted"].append(cur)
            continue
        m = _KV.match(line)
        if m and cur is not None:
            cur[m.group(1)] = m.group(2).replace('\\"', '"') \
                .replace("\\\\", "\\")
        elif cur is None:
            raise ValueError(f"unsupported baseline syntax: {line!r}")
    return out


def load_baseline(path: Path) -> list[BaselineEntry]:
    path = Path(path)
    if not path.exists():
        return []
    data = _parse_toml(path.read_text())
    entries = []
    for row in data.get("accepted", []):
        entries.append(BaselineEntry(
            rule=row.get("rule", ""), path=row.get("path", ""),
            symbol=row.get("symbol", ""), slug=row.get("slug", ""),
            reason=row.get("reason", "")))
    return entries


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def write_baseline(path: Path, findings: list[Finding],
                   reasons: dict[tuple, str] | None = None) -> None:
    """Emit a baseline pinning ``findings`` (sorted, stable output)."""
    reasons = reasons or {}
    blocks = []
    for f in sorted(findings, key=lambda f: f.key()):
        reason = reasons.get(f.key(), f.message)
        blocks.append("\n".join([
            "[[accepted]]",
            f"rule = {_quote(f.rule)}",
            f"path = {_quote(f.path)}",
            f"symbol = {_quote(f.symbol)}",
            f"slug = {_quote(f.slug)}",
            f"reason = {_quote(reason)}",
        ]))
    Path(path).write_text(_HEADER + "\n" + "\n\n".join(blocks) + "\n"
                          if blocks else _HEADER)


def apply_baseline(findings: list[Finding],
                   entries: list[BaselineEntry]):
    """Split findings into (new, accepted) and report stale pins."""
    pinned = {e.key(): e for e in entries}
    new: list[Finding] = []
    accepted: list[Finding] = []
    hit: set[tuple] = set()
    for f in findings:
        if f.key() in pinned:
            accepted.append(f)
            hit.add(f.key())
        else:
            new.append(f)
    stale = [e for k, e in pinned.items() if k not in hit]
    return new, accepted, stale
