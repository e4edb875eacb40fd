"""The port's conservation audit (repro_torch.analysis.conservation,
SIM201-204): the pure checks trip on corrupted accounting, the metered
timeline records real intervals — exactly the JAX package's on the same
seeded replay — and the real tree audits clean on the CPU."""
import dataclasses

import pytest

from repro.analysis import conservation as jax_conservation
from repro.backend.sharded import ShardedSsdBackend as JShardedSsdBackend
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro_torch.analysis.conservation import (LineEvent, _Auditor,
                                               audit_books,
                                               busy_violations,
                                               energy_violations,
                                               make_metered_timeline,
                                               metered_replay,
                                               run_conservation)
from repro_torch.flash.params import FlashParams


def _ev(line, start, end, **kw):
    return LineEvent(line, float(start), float(end), **kw)


# ------------------------------------------------------- SIM201 pure check
def test_busy_clean_books_balance():
    events = [_ev("die_sense:0", 0, 10), _ev("die_sense:0", 10, 20),
              _ev("die_sense:1", 5, 15), _ev("pcie", 2, 4)]
    assert busy_violations(events, makespan_ns=20.0) == []


def test_busy_double_charge_trips_sim201():
    """The same sense billed twice: identical intervals on one serial
    line must surface as an overlap."""
    events = [_ev("die_sense:0", 0, 10), _ev("die_sense:0", 0, 10)]
    slugs = [s for s, _ in busy_violations(events, makespan_ns=10.0)]
    assert "overlap:die_sense:0" in slugs
    # and the doubled busy time also exceeds the makespan
    assert "busy-exceeds-makespan:die_sense:0" in slugs


def test_busy_partial_overlap_trips_sim201():
    events = [_ev("chan:1", 0, 10), _ev("chan:1", 9, 12)]
    slugs = [s for s, _ in busy_violations(events, makespan_ns=50.0)]
    assert slugs == ["overlap:chan:1"]


def test_busy_negative_span_trips_sim201():
    events = [_ev("pcie", 10, 3)]
    slugs = [s for s, _ in busy_violations(events, makespan_ns=50.0)]
    assert slugs == ["negative-span:pcie"]


def test_busy_lines_are_independent():
    """Concurrent occupancy on *different* lines is the whole point of
    the parallel simulator — never a violation."""
    events = [_ev(f"die_sense:{d}", 0, 100) for d in range(8)]
    assert busy_violations(events, makespan_ns=100.0) == []


# ------------------------------------------------------- SIM202 pure check
@pytest.fixture()
def params():
    return FlashParams()


def _clean_account(params, n_senses, n_programs, bus_events, match_queries):
    from repro_torch.flash.ssd import EnergyAccount
    acct = EnergyAccount()
    acct.sense_pj = n_senses * params.e_sense_pj()
    acct.program_pj = n_programs * params.e_program_pj()
    acct.bus_pj = sum(params.e_bus_pj(n, m) for n, m in bus_events)
    acct.match_pj = match_queries * params.e_match_pj()
    return acct


def test_energy_clean_books_balance(params):
    bus = [(4096, False), (64, True)]
    acct = _clean_account(params, 10, 3, bus, 7)
    assert energy_violations(acct, params, n_senses=10, n_programs=3,
                             bus_events=bus, match_queries=7) == []


def test_energy_dropped_charge_trips_sim202(params):
    """Drop one sense charge from the account: the component check must
    flag exactly the sense bucket."""
    acct = _clean_account(params, 9, 3, [], 0)       # 9 booked...
    viols = energy_violations(acct, params, n_senses=10,  # ...10 metered
                              n_programs=3, bus_events=[],
                              match_queries=0)
    assert [s for s, _ in viols] == ["component-mismatch:sense_pj"]


def test_energy_double_charge_trips_sim202(params):
    bus = [(4096, False)]
    acct = _clean_account(params, 5, 0, bus + bus, 2)   # bus billed twice
    viols = energy_violations(acct, params, n_senses=5, n_programs=0,
                              bus_events=bus, match_queries=2)
    assert [s for s, _ in viols] == ["component-mismatch:bus_pj"]


def test_energy_total_drift_trips_sim202(params):
    """Components fine but the total out of step with their sum (a stale
    cached total) must trip the total check."""
    class DriftingAccount:
        def __init__(self, acct):
            for c in ("sense_pj", "program_pj", "bus_pj", "match_pj"):
                setattr(self, c, getattr(acct, c))
            self.total_pj = acct.total_pj * 1.01 + 1.0
    acct = DriftingAccount(_clean_account(params, 4, 1, [], 3))
    viols = energy_violations(acct, params, n_senses=4, n_programs=1,
                              bus_events=[], match_queries=3)
    assert [s for s, _ in viols] == ["total-mismatch:energy_pj"]


# ------------------------------------------------------ metered timeline
def test_metered_timeline_records_real_intervals():
    tl = make_metered_timeline(n_chips=2)
    for chip in (0, 1, 0):
        tl.observe_program(chip)
    assert tl.events, "programming pages produced no metered events"
    lines = {e.line.split(":")[0] for e in tl.events}
    assert lines == {"die_prog", "pcie"}
    # every PCIe event carries a full page
    assert all(e.n_bytes > 0 for e in tl.events if e.line == "pcie")
    assert busy_violations(tl.events, max(e.end_ns for e in tl.events)) \
        == []
    # reset() wipes the record and re-instruments the fresh sim
    tl.reset()
    assert tl.events == [] and tl.match_queries == 0


def test_auditor_collects_findings():
    aud = _Auditor("batched")
    aud.check(True, "SIM201", "timeline", "ok", "never recorded")
    aud.check(False, "SIM203", "replay", "no-result-bytes", "boom")
    aud.add("SIM201", "timeline", [("overlap:pcie", "double billed")])
    assert [(f.rule, f.path, f.slug) for f in aud.findings] == [
        ("SIM203", "audit:batched", "no-result-bytes"),
        ("SIM201", "audit:batched", "overlap:pcie")]


# ------------------------------------------- parity with the JAX package
def _jax_metered_replay():
    """The JAX conservation audit's own sharded replay, metered."""
    wl, _, _, _ = metered_replay("batched", device="cpu")
    tl = jax_conservation.make_metered_timeline(n_chips=4)
    backend = JShardedSsdBackend(
        JSimChipArray(n_chips=4, pages_per_chip=64, device_seed=11),
        page_block=8, lookup_block=8, use_kernel=False, interpret=True,
        timeline=tl)
    return jreplay(wl, backend, JRunConfig(burst=16)), tl


def test_metered_events_equal_the_jax_packages():
    """Same seeded replay: every metered interval (line, start, end, bytes,
    mode), the match-query count, clock and energy equal JAX's exactly."""
    _, rep, _, tl = metered_replay("sharded", device="cpu")
    jrep, jtl = _jax_metered_replay()
    assert tl.events, "the replay metered nothing"
    assert [dataclasses.astuple(e) for e in tl.events] == \
        [dataclasses.astuple(e) for e in jtl.events]
    assert tl.match_queries == jtl.match_queries > 0
    assert tl.now == jtl.now
    assert tl.sim.energy.total_pj == jtl.sim.energy.total_pj
    for f in ("staged_bytes", "result_bytes", "kernel_launches"):
        assert getattr(rep.counters, f) == getattr(jrep.counters, f)


# ------------------------------------------------------- the books tripping
def test_audit_books_trips_on_corrupted_books():
    _, rep, backend, tl = metered_replay("sharded", device="cpu")
    assert audit_books("sharded", rep, backend, tl) == []
    sense = next(e for e in tl.events if e.line.startswith("die_sense:"))
    tl.events.append(sense)                  # one sense billed twice
    backend.stats.result_bytes += 64         # a counter the report lacks
    tl.sim.stats.pcie_bytes += 1             # PCIe bytes nothing carried
    got = {(f.rule, f.slug) for f in audit_books("sharded", rep, backend,
                                                 tl)}
    assert got == {("SIM201", f"overlap:{sense.line}"),
                   ("SIM202", "component-mismatch:sense_pj"),
                   ("SIM203", "report-mismatch:result_bytes"),
                   ("SIM203", "pcie-bytes-mismatch")}


# -------------------------------------------------------- the full audit
def test_conservation_audit_clean_on_real_tree():
    """The seeded replays' books balance end to end on both backends: busy
    time, energy, bytes and fault accounting."""
    findings = run_conservation(device="cpu")
    assert findings == [], [f.format() for f in findings]
