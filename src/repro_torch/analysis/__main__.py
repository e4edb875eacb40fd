"""CLI for the port's contract auditor: ``python -m repro_torch.analysis``.

Default run executes all three prongs — the AST contract lint
(SIM001..SIM009) over ``src/repro_torch``, the launch audit
(SIM101..SIM104) over the batched and sharded backends, and the runtime
conservation audit (SIM201..SIM204) of the timeline accounting — applies
``baseline.toml`` and prints every finding.  The audits run on the card;
``--device cpu`` runs them on the plain PyTorch versions of the kernels,
and without a card and without ``--device cpu`` the run raises (an audit
whose setup fails is an error, never a skipped prong).  Each audited flush
phase's launches by kernel (``native.LAUNCHES`` deltas) go to stderr.
``--check`` turns non-baselined findings into a nonzero exit;
``--write-baseline`` regenerates the allowlist from the current tree
(reasons of already-pinned entries are preserved).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .baseline import apply_baseline, load_baseline, write_baseline
from .contracts import PACKAGE_ROOT, run_contracts
from .findings import Finding

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.toml"
REPO_ROOT = Path(__file__).resolve().parents[3]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="SiM backend-contract auditor of the port: AST lint "
                    "(SIM001..009) + launch audit (SIM101..104) + runtime "
                    "conservation audit (SIM201..204).")
    p.add_argument("--check", action="store_true",
                   help="exit nonzero when any non-baselined finding exists")
    p.add_argument("--write-baseline", action="store_true",
                   help="regenerate the baseline from the current findings "
                        "(keeps reasons of entries that are still hit)")
    p.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                   help="allowlist path (default: the committed "
                        "src/repro_torch/analysis/baseline.toml)")
    p.add_argument("--paths", type=Path, nargs="*", default=None,
                   help="lint these files/dirs instead of src/repro_torch")
    p.add_argument("--rules", nargs="*", default=None,
                   help="restrict the lint to these rule IDs (e.g. SIM001)")
    p.add_argument("--no-lint", action="store_true",
                   help="skip the AST contract lint")
    p.add_argument("--no-audit", action="store_true",
                   help="skip the launch audit")
    p.add_argument("--no-conservation", action="store_true",
                   help="skip the runtime conservation audit (SIM201..204)")
    p.add_argument("--device", default=None,
                   help="device of the audits: the card by default, 'cpu' "
                        "for the plain PyTorch versions of the kernels")
    return p


def _select_rules(ids):
    from .rules import RULES_BY_ID
    unknown = [r for r in ids if r not in RULES_BY_ID]
    if unknown:
        raise SystemExit(f"unknown rule IDs {unknown}; "
                         f"known: {sorted(RULES_BY_ID)}")
    return [RULES_BY_ID[r] for r in ids]


def collect_findings(args, phase_log: list | None = None) -> list[Finding]:
    findings: list[Finding] = []
    if not (args.no_audit and args.no_conservation):
        from repro_torch.device import resolve_device
        device = resolve_device(args.device)     # raises without a card
    if not args.no_lint:
        rules = _select_rules(args.rules) if args.rules else None
        paths = args.paths if args.paths is not None \
            else [REPO_ROOT / PACKAGE_ROOT]
        findings.extend(run_contracts(REPO_ROOT, paths=paths, rules=rules))
    if not args.no_audit:
        from .launch_audit import run_audit
        phases: list = []
        findings.extend(run_audit(device=device, phase_log=phases))
        for ph in phases:
            print(ph.format(), file=sys.stderr)
        if phase_log is not None:
            phase_log.extend(phases)
    if not args.no_conservation:
        from .conservation import run_conservation
        findings.extend(run_conservation(device=device))
    return findings


def main(argv=None, *, phase_log: list | None = None) -> int:
    """Run the auditor; ``phase_log`` receives the launch audit's
    per-phase :class:`~.launch_audit.PhaseLog` records."""
    args = build_parser().parse_args(argv)
    findings = collect_findings(args, phase_log)
    entries = load_baseline(args.baseline)

    if args.write_baseline:
        reasons = {e.key(): e.reason for e in entries if e.reason}
        write_baseline(args.baseline, findings, reasons)
        print(f"wrote {len(findings)} accepted findings to {args.baseline}")
        return 0

    new, accepted, stale = apply_baseline(findings, entries)
    for f in new:
        print(f.format())
    for e in stale:
        print(f"stale baseline entry (no longer found): "
              f"{e.rule} {e.path} {e.symbol} [{e.slug}]", file=sys.stderr)
    print(f"{len(new)} new finding(s), {len(accepted)} baselined, "
          f"{len(stale)} stale baseline entr(ies)", file=sys.stderr)

    if args.check and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
