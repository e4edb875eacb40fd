"""Runtime conservation audit of the timeline accounting (SIM201–204).

The static prongs (AST rules, launch audit) prove the *shape* of the
accounting is right; this prong proves the books actually balance at
runtime.  It replays a small seeded YCSB slice per backend through the
real frontend, on the card unless ``device="cpu"``, with a metering
``BurstTimeline`` subclass that records every resource-line occupancy
interval ``SSDSim`` grants, then audits — the timeline-layer sibling of
SIM104's operand byte reconciliation.  :func:`audit_books` runs the same
SIM201–SIM203 checks over any replay on a metered timeline, at any size:

  * **SIM201 (busy-time conservation)** — every resource line (each
    die's sense and program timelines, each channel bus, the PCIe link)
    is a serial resource: its recorded intervals must not overlap, spans
    must be non-negative, and total busy time is bounded by the run's
    makespan.  A double-charged interval (the same sense billed twice)
    or a line busier than the clock trips it.
  * **SIM202 (energy conservation)** — the ``EnergyAccount`` must equal
    an independent recomputation from the metered events: #senses x
    ``e_sense_pj()``, #programs x ``e_program_pj()``, the per-transfer
    ``e_bus_pj`` sum and #match-queries x ``e_match_pj()``; the reported
    ``energy_pj`` must equal the sum of its components.  A dropped or
    doubled charge anywhere in the chain trips it.
  * **SIM203 (byte reconciliation)** — ``staged_bytes``,
    ``result_bytes`` and ``kernel_launches`` in the ``RunReport`` must
    equal the backend's own counters, and the simulator's
    ``internal_bytes``/``pcie_bytes`` must equal the bytes the metered
    bus/PCIe events actually carried.
  * **SIM204 (fault accounting)** — ``FaultStats`` must be consistent
    with the per-op error mask: ``n_op_errors`` equals the mask's
    popcount, a healthy schedule fires nothing, and a dead chip with
    replicas surfaces as failovers/degraded reads with zero op errors.

Findings carry path ``audit:<kind>`` and flow through the same
``(rule, path, symbol, slug)`` baseline diff as every other prong.
"""
from __future__ import annotations

import dataclasses

from .findings import Finding

#: audited resource-line tolerance: float accumulation across a few
#: hundred events stays far below a nanosecond
TOL_NS = 1e-6
REL_TOL = 1e-9


@dataclasses.dataclass
class LineEvent:
    """One occupancy interval granted on a serial resource line."""
    line: str                   # "die_sense:<d>" | "die_prog:<d>"
                                # | "chan:<c>" | "pcie"
    start_ns: float
    end_ns: float
    n_bytes: int = 0            # payload (bus/PCIe events only)
    match_mode: bool = False    # bus events: match vs storage transfer


def make_metered_timeline(params=None, *, n_chips: int | None = None):
    """A ``BurstTimeline`` whose ``SSDSim`` resource methods are wrapped
    to record :class:`LineEvent` intervals (``.events``) and match-query
    counts (``.match_queries``).  Records survive until the next
    ``reset()`` — ``frontend.replay`` resets after the page load, so the
    record covers exactly the measured window, like the latency lists.
    """
    from repro_torch.flash.timeline import BurstTimeline

    class MeteredTimeline(BurstTimeline):
        def reset(self):
            # BurstTimeline.__init__ calls reset() before any subclass
            # state exists: containers must (re)initialize here.
            self.events: list[LineEvent] = []
            self.match_queries = 0
            super().reset()
            self._instrument(self.sim)

        def _instrument(self, sim):
            orig = {name: getattr(sim, name)
                    for name in ("_sense", "_program", "_bus", "_pcie",
                                 "_match")}

            def sense(page, ready):
                die = sim._die_of(page)
                free = float(sim.die_sense_free[die])
                end = orig["_sense"](page, ready)
                self.events.append(LineEvent(
                    f"die_sense:{die}", max(ready, free), end))
                return end

            def program(page, ready):
                die = sim._die_of(page)
                free = float(sim.die_prog_free[die])
                end = orig["_program"](page, ready)
                self.events.append(LineEvent(
                    f"die_prog:{die}", max(ready, free), end))
                return end

            def bus(page, ready, n_bytes, match_mode):
                chan = sim._chan_of(sim._die_of(page))
                free = float(sim.chan_free[chan])
                end = orig["_bus"](page, ready, n_bytes, match_mode)
                self.events.append(LineEvent(
                    f"chan:{chan}", max(ready, free), end,
                    n_bytes=n_bytes, match_mode=match_mode))
                return end

            def pcie(ready, n_bytes):
                free = float(sim.pcie_free)
                end = orig["_pcie"](ready, n_bytes)
                self.events.append(LineEvent(
                    "pcie", max(ready, free), end, n_bytes=n_bytes))
                return end

            def match(ready, n_queries=1):
                self.match_queries += n_queries
                return orig["_match"](ready, n_queries)

            sim._sense, sim._program = sense, program
            sim._bus, sim._pcie, sim._match = bus, pcie, match

    if params is None:
        params = BurstTimeline.for_chips(n_chips or 4).params
    return MeteredTimeline(params)


# ----------------------------------------------------------- pure checks
def busy_violations(events, makespan_ns: float) -> list[tuple[str, str]]:
    """SIM201: per-line interval sanity.  Returns ``(slug, message)``
    violations — empty when the books balance."""
    out: list[tuple[str, str]] = []
    by_line: dict[str, list[LineEvent]] = {}
    for ev in events:
        by_line.setdefault(ev.line, []).append(ev)
    for line, evs in sorted(by_line.items()):
        evs = sorted(evs, key=lambda e: (e.start_ns, e.end_ns))
        busy = 0.0
        prev_end = None
        for ev in evs:
            if ev.end_ns < ev.start_ns - TOL_NS:
                out.append((f"negative-span:{line}",
                            f"{line}: interval ends at {ev.end_ns} before "
                            f"it starts at {ev.start_ns}"))
                continue
            if prev_end is not None and ev.start_ns < prev_end - TOL_NS:
                out.append((f"overlap:{line}",
                            f"{line}: interval starting at {ev.start_ns} "
                            f"overlaps the previous one ending at "
                            f"{prev_end} — a serial resource was charged "
                            "twice for the same time"))
            busy += ev.end_ns - ev.start_ns
            prev_end = max(prev_end or 0.0, ev.end_ns)
        if busy > makespan_ns + TOL_NS:
            out.append((f"busy-exceeds-makespan:{line}",
                        f"{line}: {busy:.1f} ns of busy time inside a "
                        f"{makespan_ns:.1f} ns makespan — more work was "
                        "billed than wall-clock exists"))
    return out


def energy_violations(energy, params, *, n_senses: int, n_programs: int,
                      bus_events, match_queries: int
                      ) -> list[tuple[str, str]]:
    """SIM202: the ``EnergyAccount`` vs an independent recomputation from
    the metered events.  ``bus_events`` is an iterable of
    ``(n_bytes, match_mode)`` transfers."""
    out: list[tuple[str, str]] = []
    expected = {
        "sense_pj": n_senses * params.e_sense_pj(),
        "program_pj": n_programs * params.e_program_pj(),
        "bus_pj": sum(params.e_bus_pj(n, m) for n, m in bus_events),
        "match_pj": match_queries * params.e_match_pj(),
    }

    def close(a: float, b: float) -> bool:
        return abs(a - b) <= max(abs(a), abs(b)) * 1e-6 + 1e-9

    for comp, want in expected.items():
        got = getattr(energy, comp)
        if not close(got, want):
            out.append((f"component-mismatch:{comp}",
                        f"{comp} is {got:.3f} pJ but the metered events "
                        f"recompute {want:.3f} pJ — a charge was dropped "
                        "or doubled"))
    total = sum(getattr(energy, c) for c in expected)
    if not close(energy.total_pj, total):
        out.append(("total-mismatch:energy_pj",
                    f"energy_pj {energy.total_pj:.3f} != sum of components "
                    f"{total:.3f}"))
    return out


# ------------------------------------------------------------ the audit
class _Auditor:
    """Finding collector in the launch_audit idiom."""

    def __init__(self, kind: str):
        self.kind = kind
        self.findings: list[Finding] = []

    def check(self, ok: bool, rule: str, symbol: str, slug: str,
              message: str) -> None:
        if not ok:
            self.findings.append(Finding(
                rule, f"audit:{self.kind}", symbol, slug, message=message))

    def add(self, rule: str, symbol: str,
            violations: list[tuple[str, str]]) -> None:
        for slug, message in violations:
            self.findings.append(Finding(
                rule, f"audit:{self.kind}", symbol, slug, message=message))


def audit_books(kind: str, rep, backend, tl=None) -> list[Finding]:
    """SIM201–SIM203 over one replay: ``rep`` its report, ``backend`` the
    backend it ran on, ``tl`` the metered timeline it ran with (None for a
    backend without one: then only the counter leg of SIM203 runs)."""
    aud = _Auditor(kind)
    # --- SIM203: bytes reconcile backend <-> report (every kind)
    stats = backend.stats
    for field in ("staged_bytes", "result_bytes", "kernel_launches"):
        aud.check(getattr(rep.counters, field) == getattr(stats, field),
                  "SIM203", "replay", f"report-mismatch:{field}",
                  f"RunReport.counters.{field}="
                  f"{getattr(rep.counters, field)} != backend stats "
                  f"{getattr(stats, field)}")
    aud.check(stats.result_bytes > 0, "SIM203", "replay",
              "no-result-bytes",
              "a read-heavy replay produced zero result bytes")
    if tl is None:
        return aud.findings

    # --- SIM201: per-line busy time vs makespan
    makespan_ns = max([tl.now] + [e.end_ns for e in tl.events])
    aud.add("SIM201", "timeline", busy_violations(tl.events, makespan_ns))
    aud.check(rep.latency.makespan_ns == tl.now, "SIM201", "timeline",
              "makespan-mismatch",
              f"report makespan {rep.latency.makespan_ns} != timeline "
              f"clock {tl.now}")
    # --- SIM202: energy account vs metered recomputation
    senses = sum(e.line.startswith("die_sense:") for e in tl.events)
    programs = sum(e.line.startswith("die_prog:") for e in tl.events)
    bus_events = [(e.n_bytes, e.match_mode) for e in tl.events
                  if e.line.startswith("chan:")]
    aud.add("SIM202", "timeline", energy_violations(
        tl.sim.energy, tl.params, n_senses=senses, n_programs=programs,
        bus_events=bus_events, match_queries=tl.match_queries))
    aud.check(rep.energy.total_pj == tl.sim.energy.total_pj,
              "SIM202", "timeline", "report-mismatch:energy_pj",
              f"report energy {rep.energy.total_pj} != timeline "
              f"account {tl.sim.energy.total_pj}")
    # --- SIM203 (cross-layer leg): counters vs metered bytes
    bus_bytes = sum(n for n, _ in bus_events)
    aud.check(tl.sim.stats.internal_bytes == bus_bytes,
              "SIM203", "timeline", "bus-bytes-mismatch",
              f"sim internal_bytes {tl.sim.stats.internal_bytes} != "
              f"metered bus payload {bus_bytes}")
    pcie = sum(e.n_bytes for e in tl.events if e.line == "pcie")
    aud.check(tl.sim.stats.pcie_bytes == pcie,
              "SIM203", "timeline", "pcie-bytes-mismatch",
              f"sim pcie_bytes {tl.sim.stats.pcie_bytes} != metered "
              f"PCIe payload {pcie}")
    return aud.findings


def metered_replay(kind: str, *, device=None):
    """The audit's seeded replay: 120 ops over 4 key pages (read 0.7, Zipf
    0.5, seed 2) on 4 chips, bursts of 16; the sharded backend runs on a
    metered timeline.  Returns ``(workload, report, backend, timeline)``
    (timeline None for the batched backend)."""
    from repro_torch.backend.base import make_backend
    from repro_torch.core.engine import SimChipArray
    from repro_torch.frontend import RunConfig, replay
    from repro_torch.workload.ycsb import generate

    wl = generate(120, n_key_pages=4, read_ratio=0.7, alpha=0.5, seed=2)
    chips = SimChipArray(n_chips=4, pages_per_chip=64, device_seed=11)
    tl = make_metered_timeline(n_chips=4) if kind == "sharded" else None
    kw = {} if tl is None else {"timeline": tl}
    backend = make_backend(kind, chips, device=device, **kw)
    rep = replay(wl, backend, RunConfig(burst=16))
    return wl, rep, backend, tl


def _audit_kind(kind: str, device=None) -> list[Finding]:
    import numpy as np

    from repro_torch.backend.sharded import ShardedSsdBackend
    from repro_torch.core.engine import SimChipArray
    from repro_torch.frontend import RunConfig, replay
    from repro_torch.reliability import FaultSchedule

    wl, rep, backend, tl = metered_replay(kind, device=device)
    findings = audit_books(kind, rep, backend, tl)
    aud = _Auditor(kind)

    # --- SIM204: fault accounting (sharded only: the fault tier's home)
    if kind == "sharded":
        def replicated(replicas, faults):
            per_chip = (wl.n_index_pages // 4 + 1) * (replicas + 1)
            be = ShardedSsdBackend(
                SimChipArray(n_chips=4, pages_per_chip=per_chip,
                             device_seed=3),
                replicas=replicas, device=device)
            return replay(wl, be, RunConfig.event_serial(
                faults=faults, burst=16, seed=7))

        healthy = replicated(2, FaultSchedule.healthy(seed=7))
        f = healthy.faults
        aud.check((f.timeouts, f.retries, f.failovers, f.degraded_ops,
                   f.n_op_errors) == (0, 0, 0, 0, 0),
                  "SIM204", "faults", "healthy-run-fired",
                  "a healthy fault schedule produced nonzero fault "
                  "counters")
        dead = replicated(2, FaultSchedule.dead_chip(chip=0, seed=7))
        f = dead.faults
        aud.check(f.op_errors is not None
                  and len(f.op_errors) == len(wl.ops),
                  "SIM204", "faults", "mask-shape",
                  "op_errors mask does not cover every op")
        aud.check(f.op_errors is not None
                  and f.n_op_errors == int(np.sum(f.op_errors)),
                  "SIM204", "faults", "mask-count-mismatch",
                  f"n_op_errors={f.n_op_errors} != popcount of the "
                  "op_errors mask")
        aud.check(f.failovers > 0 and f.degraded_ops > 0,
                  "SIM204", "faults", "dead-chip-invisible",
                  "a dead chip with replicas produced no failovers or "
                  "degraded reads — the fault path did not run")
        aud.check(f.n_op_errors == 0, "SIM204", "faults",
                  "replicated-errors",
                  "replicas=2 should absorb a single dead chip with zero "
                  "op errors")
    return findings + aud.findings


def run_conservation(*, device=None) -> list[Finding]:
    """Run the seeded conservation replays of both kernel backends on
    ``device`` (None: the card); returns all findings."""
    out: list[Finding] = []
    for kind in ("batched", "sharded"):
        out.extend(_audit_kind(kind, device))
    return out
