"""Finding: one contract violation, keyed stably for the baseline.

The baseline key deliberately excludes line numbers: unrelated edits above
a pinned finding must not invalidate the pin.  ``(rule, path, symbol,
slug)`` identifies a finding by what it is and where it lives — the rule
ID, the repo-relative file, the enclosing function's qualname, and a short
rule-specific token (e.g. ``dropped:submit_program``).  Line numbers ride
along for display only.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                  # "SIM001".."SIM009" (lint), "SIM101".. (audits)
    path: str                  # repo-relative posix path (or audit:<kind>)
    symbol: str                # enclosing function qualname / audit step
    slug: str                  # stable rule-specific token
    message: str = ""          # human-readable one-liner (not in the key)
    line: int = 0              # display only (not in the key)

    def key(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.slug)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule} {loc} [{self.symbol}] {self.slug}: {self.message}"


def dedupe_slugs(findings: list[Finding]) -> list[Finding]:
    """Disambiguate repeated keys with an ordinal suffix (``...#2``).

    Two independent violations of one rule in one function can produce the
    same slug; the baseline must be able to pin one without hiding the
    other, so repeats get a stable per-function ordinal.
    """
    seen: dict[tuple, int] = {}
    out: list[Finding] = []
    for f in findings:
        k = f.key()
        n = seen.get(k, 0)
        seen[k] = n + 1
        if n:
            f = dataclasses.replace(f, slug=f"{f.slug}#{n + 1}")
        out.append(f)
    return out
