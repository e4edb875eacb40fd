"""The port's contract linter (repro_torch.analysis): torch-idiom fixtures,
parity with the JAX linter on its own fixtures, scope, baseline and CLI.

The rules whose JAX fixtures are idiom-neutral (SIM001, 002, 004-007,
009) lint re-rooted copies of ``tests/analysis_fixtures/`` and must find
exactly what the JAX linter finds on the originals, by (rule, symbol,
slug, line).  SIM003 and SIM008 changed idiom and have fixtures of their
own in ``tests/torch_analysis_fixtures/``.
"""
from pathlib import Path

import pytest

from repro.analysis.contracts import run_contracts as jax_run_contracts
from repro.analysis.rules import RULES_BY_ID as JAX_RULES
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.baseline import (BaselineEntry, _parse_minimal,
                                           apply_baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.contracts import (PACKAGE_ROOT, parse_module,
                                            run_contracts)
from repro_torch.analysis.findings import Finding, dedupe_slugs
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

ROOT = Path(__file__).resolve().parents[1]
JAX_FIXTURES = Path(__file__).parent / "analysis_fixtures"
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
BASELINE = ROOT / "src" / "repro_torch" / "analysis" / "baseline.toml"
NEUTRAL_RULES = ("SIM001", "SIM002", "SIM004", "SIM005", "SIM006", "SIM007",
                 "SIM009")


def lint(path: Path, rule_id: str) -> list[Finding]:
    return [f for f in run_contracts(ROOT, paths=[path],
                                     rules=[RULES_BY_ID[rule_id]])
            if f.rule == rule_id]


def rerooted(tmp_path: Path, name: str, pretend: str | None = None) -> Path:
    """A copy of JAX fixture ``name`` whose pragma points into the port."""
    lines = (JAX_FIXTURES / name).read_text().splitlines()
    head = "# analysis: pretend-path="
    assert lines[0].startswith(head + "src/repro/")
    lines[0] = head + (pretend or lines[0][len(head):].replace(
        "src/repro/", PACKAGE_ROOT, 1))
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return p


def keys(findings) -> set:
    return {(f.rule, f.symbol, f.slug, f.line) for f in findings}


# ----------------------------------------------- parity on the JAX fixtures
@pytest.mark.parametrize("rule_id", NEUTRAL_RULES)
def test_rerooted_jax_fixtures_match_the_jax_linter(rule_id, tmp_path):
    """Every JAX fixture, re-rooted: the port's rule finds exactly what the
    JAX rule finds on the original (and something on the rule's own TP)."""
    own_tp = 0
    for src in sorted(JAX_FIXTURES.glob("sim*.py")):
        want = keys(jax_run_contracts(ROOT, paths=[src],
                                      rules=[JAX_RULES[rule_id]]))
        got = keys(lint(rerooted(tmp_path, src.name), rule_id))
        assert got == want, src.name
        if src.name == f"{rule_id.lower()}_tp.py":
            own_tp = len(got)
    assert own_tp > 0


@pytest.mark.parametrize("rule_id", NEUTRAL_RULES)
def test_rerooted_true_negatives_are_clean(rule_id, tmp_path):
    p = rerooted(tmp_path, f"{rule_id.lower()}_tn.py")
    assert lint(p, rule_id) == []


def test_sim002_rehomed_into_the_port_engine(tmp_path):
    found = lint(rerooted(tmp_path, "sim002_tp.py"), "SIM002")
    assert [(f.path, f.symbol, f.slug) for f in found] == [
        ("src/repro_torch/core/engine.py", "FixtureChip.silent_rewrite",
         "mutates:pages")]


def test_sim001_and_sim009_split_as_in_the_jax_package(tmp_path):
    p = rerooted(tmp_path, "sim001_tp.py")
    assert "dropped:submit_search" in {f.slug for f in lint(p, "SIM001")}
    found9 = lint(p, "SIM009")
    assert {f.symbol for f in found9} == {"mixed_burst"}


@pytest.mark.parametrize("rule_id,layer", [
    ("SIM005", "backend"), ("SIM005", "reliability"),
    ("SIM006", "workload")])
def test_out_of_scope_layers_exempt(rule_id, layer, tmp_path):
    """SIM005's plumbing layers and SIM006's non-fault layers of the port
    are out of scope, as in the JAX package."""
    p = rerooted(tmp_path, f"{rule_id.lower()}_tp.py",
                 f"{PACKAGE_ROOT}{layer}/fixture.py")
    assert lint(p, rule_id) == []


# ------------------------------------------------------ torch-idiom fixtures
def test_sim003_torch_true_positives():
    found = lint(FIXTURES / "sim003_tp.py", "SIM003")
    assert {(f.symbol, f.slug) for f in found} == {
        ("_flush_searches", "host-sync:cpu"),
        ("_flush_searches", "host-sync:tensor_to_words"),
        ("_flush_searches", "host-sync:item"),
        ("_flush_searches", "host-sync:synchronize"),
        ("_flush_plans", "host-sync:int"),
        ("_flush_plans", "host-sync:tolist"),
        ("_flush_plans", "host-sync:numpy")}
    assert all(f.path == "src/repro_torch/backend/fixture_flush.py"
               for f in found)


def test_sim003_torch_true_negatives():
    assert lint(FIXTURES / "sim003_tn.py", "SIM003") == []


def test_sim008_torch_true_positives():
    found = lint(FIXTURES / "sim008_tp.py", "SIM008")
    assert {(f.symbol, f.slug) for f in found} == {
        ("no_entropy_at_all", "unseeded-rng"),
        ("bare_generator", "unseeded-rng"),
        ("draw_on_global_rng", "unseeded-rng"),
        ("os_entropy_laundered", "untraced-rng"),
        # interprocedural: the parameter's provenance fails at a call site
        ("_fixture_gen_from_knob", "untraced-rng:knob")}


def test_sim008_torch_true_negatives():
    assert lint(FIXTURES / "sim008_tn.py", "SIM008") == []


def test_sim003_jax_fixture_idiom_is_not_the_ports(tmp_path):
    """The JAX fixture's ``block_until_ready`` is no torch sync; its
    ``np.asarray`` and ``int()`` of a launch output still are."""
    found = lint(rerooted(tmp_path, "sim003_tp.py"), "SIM003")
    assert {f.slug for f in found} == {"host-sync:np.asarray",
                                       "host-sync:int"}


def test_pragma_rehomes_fixture():
    mod = parse_module(FIXTURES / "sim003_tp.py", ROOT)
    assert mod.rel_path == "src/repro_torch/backend/fixture_flush.py"
    assert mod.real_path.endswith(
        "tests/torch_analysis_fixtures/sim003_tp.py")


# ---------------------------------------------------------------- the scope
def test_every_rule_visits_real_port_files():
    """The trap of a mechanical port: a rule still scoped to ``src/repro/``
    lints nothing of ``src/repro_torch`` and reports clean."""
    rels = [p.relative_to(ROOT).as_posix()
            for p in sorted((ROOT / PACKAGE_ROOT).rglob("*.py"))]
    assert rels
    for rule in ALL_RULES:
        hits = [r for r in rels if rule.applies_to(r)]
        assert hits, f"{rule.rule_id} applies to no file of the port"


@pytest.mark.parametrize("rule_id", ["SIM002", "SIM003", "SIM004", "SIM005",
                                     "SIM006"])
def test_path_scoped_rules_leave_the_jax_package_alone(rule_id):
    rule = RULES_BY_ID[rule_id]
    for rel in ("src/repro/backend/planestore.py", "src/repro/core/engine.py",
                "src/repro/frontend/replay.py", "src/repro/index/btree.py"):
        assert not rule.applies_to(rel)


# ------------------------------------------------------------------ baseline
def test_baseline_roundtrip(tmp_path):
    findings = [
        Finding("SIM001", "src/a.py", "f", 'dropped:submit_search',
                message='reason with "quotes" and \\ backslash'),
        Finding("SIM004", "src/b.py", "C.g", "mutates:flushes"),
    ]
    path = tmp_path / "baseline.toml"
    write_baseline(path, findings)
    entries = load_baseline(path)
    assert {e.key() for e in entries} == {f.key() for f in findings}
    by_key = {e.key(): e for e in entries}
    assert by_key[findings[0].key()].reason == \
        'reason with "quotes" and \\ backslash'

    new, accepted, stale = apply_baseline(findings, entries)
    assert new == [] and len(accepted) == 2 and stale == []
    extra = Finding("SIM002", "src/c.py", "h", "mutates:pages")
    new, _, _ = apply_baseline(findings + [extra], entries)
    assert new == [extra]
    _, _, stale = apply_baseline([findings[0]], entries)
    assert [e.key() for e in stale] == [findings[1].key()]


def test_minimal_parser_matches_tomllib():
    tomllib = pytest.importorskip("tomllib")
    text = BASELINE.read_text()
    assert _parse_minimal(text) == tomllib.loads(text)


def test_load_missing_baseline_is_empty(tmp_path):
    assert load_baseline(tmp_path / "nope.toml") == []


def test_stale_entry_reported():
    entry = BaselineEntry("SIM001", "gone.py", "f", "dropped:submit_x")
    new, accepted, stale = apply_baseline([], [entry])
    assert stale == [entry] and new == [] and accepted == []


def test_dedupe_slugs_ordinal():
    f = Finding("SIM001", "a.py", "f", "dropped:submit_search")
    assert [x.slug for x in dedupe_slugs([f, f, f])] == [
        "dropped:submit_search", "dropped:submit_search#2",
        "dropped:submit_search#3"]


def test_write_baseline_preserves_reasons(tmp_path):
    findings = [Finding("SIM001", "src/a.py", "f", "dropped:submit_search",
                        message="msg")]
    path = tmp_path / "b.toml"
    write_baseline(path, findings,
                   reasons={findings[0].key(): "reviewed: intentional"})
    assert load_baseline(path)[0].reason == "reviewed: intentional"


def test_port_baseline_pins_only_what_the_tree_needs():
    """Three pins, all re-keyed into the port with a reason; no SIM004
    (the launch helpers' counter writes were repaired, not pinned)."""
    entries = load_baseline(BASELINE)
    assert {(e.rule, e.path, e.symbol) for e in entries} == {
        ("SIM002", "src/repro_torch/backend/planestore.py",
         "PlaneStore._grow"),
        ("SIM009", "src/repro_torch/frontend/replay.py",
         "ReplayCore._resolve_burst_split"),
        ("SIM009", "src/repro_torch/index/hashindex.py",
         "SimHashIndex.lookup_batch")}
    assert all(e.reason for e in entries)
    assert not any(e.rule == "SIM004" for e in entries)


def test_launch_helpers_write_no_counters():
    """The repaired SIM004 findings: ``launch_lookups``/``launch_gathers``
    leave ``BackendStats`` to the calling ``_flush_*`` phases."""
    path = ROOT / PACKAGE_ROOT / "backend" / "batched.py"
    assert lint(path, "SIM004") == []


# ----------------------------------------------------------------- CLI gate
def test_repo_lint_is_clean_under_baseline(capsys):
    assert main(["--check", "--no-audit", "--no-conservation"]) == 0
    err = capsys.readouterr().err
    assert "0 new finding(s), 3 baselined" in err
    assert "0 stale baseline entr" in err


def test_fixture_violations_trip_the_gate(tmp_path, capsys):
    for src in JAX_FIXTURES.glob("sim*.py"):
        if not src.name.startswith(("sim003", "sim008")):
            rerooted(tmp_path, src.name)
    for src in FIXTURES.glob("sim*.py"):
        (tmp_path / src.name).write_text(src.read_text())
    rc = main(["--check", "--no-audit", "--no-conservation",
               "--paths", str(tmp_path)])
    assert rc == 1
    out = capsys.readouterr().out
    for rule in RULES_BY_ID:
        assert rule in out


def test_unknown_rule_id_rejected():
    with pytest.raises(SystemExit):
        main(["--no-audit", "--no-conservation", "--rules", "SIM999"])


def test_audits_without_a_card_raise(monkeypatch):
    """No fallback: the audits run on the card unless --device cpu."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--check", "--no-lint", "--no-conservation"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--check", "--no-lint", "--no-audit"])


def test_no_hlo_option_is_gone():
    with pytest.raises(SystemExit):
        main(["--no-lint", "--no-hlo"])
