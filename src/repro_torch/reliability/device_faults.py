"""Device-level fault model: outages, stalls, grown bad blocks (§IV-C).

:class:`~repro_torch.reliability.faults.FaultModel` damages *bits*; this
module damages *devices*.  A :class:`FaultSchedule` is a frozen, seeded
description of everything that goes wrong with the hardware during one
replay:

  * **transient stalls** (:class:`StallWindow`) — a die or channel is
    unavailable for a window of simulated time (a retention scrub, a
    thermal throttle, a firmware hiccup).  Stalls are *scheduled onto the
    SSDSim resource lines* (``die_sense_free``/``die_prog_free``/
    ``chan_free``) by ``BurstTimeline.observe_flush``
    (flash/timeline.py), so a burst that lands in a window
    queues behind it exactly like any other resource contention — which
    is how stalls surface as command timeouts in the event frontend;
  * **permanent outages** (:class:`ChipOutage`) — a chip (== die in the
    adapter geometry) stops answering at ``t_fail_ns`` and never comes
    back.  The sharded backend serves its pages from replicas
    (``failovers``) or degrades to host-side full-page reads; a page with
    no surviving replica fails its ticket with a typed
    ``DegradedReadError`` (errors.py);
  * **program failures** — a page program fails with probability
    ``program_fail_prob`` (a seeded per-(page, attempt) draw), growing
    the bad-block set: the backend remaps the page to a spare and
    reprograms (``remapped_blocks``), bounded-retry, never silently.

Every draw is keyed on ``(schedule seed, page, attempt)`` SeedSequence
entropy — the same discipline as :class:`repro_torch.reliability.faults.
FaultModel` — so one seed reproduces byte-identical fault counters
across backends and process restarts, equal to the JAX package's.

:class:`DeviceFaultState` is the mutable replay-side wrapper: it carries
the monotone fault clock (advanced by the event loop at every dispatch),
the grown bad-block set, the remap table, and the :class:`FaultStats`
counters that ``RunReport.faults`` snapshots.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MS_NS = 1_000_000.0


class CommandTimeoutError(RuntimeError):
    """A request exceeded its deadline on every allowed attempt: the typed
    completion the event loop reports instead of blocking forever."""

    def __init__(self, qi: int, attempts: int, deadline_ns: float):
        self.qi = qi
        self.attempts = attempts
        self.deadline_ns = deadline_ns
        super().__init__(f"op {qi}: {attempts} attempt(s) all exceeded the "
                         f"{deadline_ns:.0f} ns deadline")


class OverloadShedError(RuntimeError):
    """The NCQ and its overflow queue are full: the arrival is shed with a
    typed error instead of queueing unboundedly (backpressure, not OOM)."""

    def __init__(self, qi: int):
        self.qi = qi
        super().__init__(f"op {qi}: shed at admission (queue at capacity)")


@dataclasses.dataclass(frozen=True)
class StallWindow:
    """One die or channel unavailable during [t_start_ns, t_end_ns)."""
    kind: str                   # "die" | "channel"
    target: int                 # die index or channel index
    t_start_ns: float
    t_end_ns: float

    def __post_init__(self) -> None:
        if self.kind not in ("die", "channel"):
            raise ValueError(f"stall kind {self.kind!r} not die/channel")
        if self.t_end_ns <= self.t_start_ns:
            raise ValueError("stall window must have t_end_ns > t_start_ns")


@dataclasses.dataclass(frozen=True)
class ChipOutage:
    """Chip (== die) permanently offline from ``t_fail_ns`` on."""
    chip: int
    t_fail_ns: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Frozen, seeded description of one replay's device faults."""
    seed: int = 0
    stalls: tuple = ()          # tuple[StallWindow, ...]
    outages: tuple = ()         # tuple[ChipOutage, ...]
    program_fail_prob: float = 0.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "stalls", tuple(self.stalls))
        object.__setattr__(self, "outages", tuple(self.outages))
        if not 0.0 <= self.program_fail_prob < 1.0:
            raise ValueError("program_fail_prob must be in [0, 1)")

    # ------------------------------------------------------------ scenarios
    @classmethod
    def healthy(cls, seed: int = 0) -> "FaultSchedule":
        """No faults — the parity anchor (replay must be bit-identical to
        the fault-free replay, counters all zero)."""
        return cls(seed=seed)

    @classmethod
    def transient_stall(cls, *, die: int = 0, t_start_ms: float = 0.1,
                        dur_ms: float = 2.0, seed: int = 0
                        ) -> "FaultSchedule":
        """One die stalls mid-run (a scrub/throttle window): reads queue
        behind the window, time out, and recover via retry/backoff."""
        t0 = t_start_ms * MS_NS
        return cls(seed=seed, stalls=(
            StallWindow("die", die, t0, t0 + dur_ms * MS_NS),))

    @classmethod
    def dying_die(cls, *, die: int = 1, t_fail_ms: float = 0.5,
                  program_fail_prob: float = 0.02, seed: int = 0
                  ) -> "FaultSchedule":
        """A die browns out (repeated stalls), then fails for good, with
        elevated program failures growing bad blocks along the way."""
        t_fail = t_fail_ms * MS_NS
        stalls = tuple(
            StallWindow("die", die, t_fail * f, t_fail * (f + 0.15))
            for f in (0.2, 0.5, 0.8))
        return cls(seed=seed, stalls=stalls,
                   outages=(ChipOutage(die, t_fail),),
                   program_fail_prob=program_fail_prob)

    @classmethod
    def dead_chip(cls, *, chip: int = 0, seed: int = 0) -> "FaultSchedule":
        """A chip dead from t=0: every read of its pages must fail over to
        a replica (or degrade host-side) — none may return wrong data."""
        return cls(seed=seed, outages=(ChipOutage(chip, 0.0),))


@dataclasses.dataclass
class FaultStats:
    """Fault-path outcome counters (the ``faults`` report section).

    All counts are deterministic under one (workload seed, fault seed)
    pair — the chaos-sweep regression gate holds them exactly.
    """
    timeouts: int = 0           # deadline expiries (one per timed-out burst
                                # membership, before the retry decision)
    retries: int = 0            # NCQ re-admissions of timed-out requests
    backoff_waits: int = 0      # backoff delays served before re-admission
    hedges_won: int = 0         # hedged duplicate bursts that finished first
    failovers: int = 0          # reads served from a replica page
    remapped_blocks: int = 0    # grown bad blocks remapped to spares
    degraded_ops: int = 0       # host-side full-page degraded executions
    shed_requests: int = 0      # arrivals shed at admission (backpressure)
    replica_programs: int = 0   # extra page programs fanning out to replicas
    program_failures: int = 0   # seeded program-failure draws that fired

    def snapshot(self) -> "FaultStats":
        return dataclasses.replace(self)


class DeviceFaultState:
    """Mutable replay-side fault state shared by backend and frontend.

    One instance per replay: the event loop advances :attr:`now_ns` at
    every dispatch, the sharded backend consults :meth:`chip_dead` /
    :meth:`program_fails` at flush time, and the timeline schedules
    :meth:`stalls_active_at` onto the SSDSim resource lines — so timing
    and functional behaviour agree on what has failed *when*.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.now_ns = 0.0
        self.stats = FaultStats()
        self.bad_blocks: set[int] = set()      # global page addrs gone bad
        self.remap: dict[int, int] = {}        # global addr -> spare addr

    # --------------------------------------------------------------- clock
    def advance(self, t_ns: float) -> None:
        """Monotone fault clock: dispatch timestamps only move it forward."""
        if t_ns > self.now_ns:
            self.now_ns = t_ns

    # -------------------------------------------------------------- faults
    def chip_dead(self, chip: int, at_ns: float | None = None) -> bool:
        t = self.now_ns if at_ns is None else at_ns
        return any(o.chip == chip and t >= o.t_fail_ns
                   for o in self.schedule.outages)

    def dead_chips(self, at_ns: float | None = None) -> set[int]:
        t = self.now_ns if at_ns is None else at_ns
        return {o.chip for o in self.schedule.outages if t >= o.t_fail_ns}

    def stalls_active_at(self, t_ns: float):
        """Windows that have started by ``t_ns`` and not yet ended —
        the set the timeline blocks its resource lines with."""
        return [w for w in self.schedule.stalls
                if w.t_start_ns <= t_ns < w.t_end_ns]

    def program_fails(self, page_addr: int, attempt: int) -> bool:
        """Seeded per-(page, attempt) program-failure draw."""
        p = self.schedule.program_fail_prob
        if p <= 0.0:
            return False
        rng = np.random.default_rng(
            [self.schedule.seed ^ 0xBADB10C, page_addr, attempt])
        fired = bool(rng.random() < p)
        if fired:
            self.stats.program_failures += 1
        return fired

    def mark_bad(self, page_addr: int, spare_addr: int) -> None:
        """Grow the bad-block set and record the spare remap."""
        self.bad_blocks.add(page_addr)
        self.remap[page_addr] = spare_addr
        self.stats.remapped_blocks += 1
