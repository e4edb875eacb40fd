"""Event-loop frontend: NCQ admission, scheduled bursts, async programs.

The serial replay answers "what does the device compute"; this module
answers "when", under contention.  It is a next-event time-advance
simulator in the FTL-simulator shape:

  * **arrivals** — every workload op becomes a timestamped request on one
    of N client streams (:mod:`repro_torch.frontend.arrivals`);
  * **admission** — a bounded NCQ of ``config.ncq_depth`` slots; arrivals
    beyond the bound wait in an overflow queue (``admission_waits``) and
    are admitted as completions free slots — admission wait is part of
    the request's measured latency, which is how saturation shows up in
    the p99 sweeps;
  * **scheduling** — a :mod:`repro_torch.frontend.scheduler` policy
    composes the next device burst from the queued requests: up to
    ``burst`` reads coalesce into one flush (the §IV-E batch), writes and
    scans dispatch as barrier ops;
  * **service** — each burst is charged to this frontend's own
    :class:`repro_torch.flash.timeline.BurstTimeline` (die sense/program
    lines, channel buses, the PCIe link), started at the dispatch event's
    timestamp.  Under FIFO, read bursts additionally queue behind each
    die's outstanding program backlog; read-priority policies
    program-suspend past it — with t_program = 5 x t_read this gap is the
    whole fig15-under-contention story;
  * **background programs** — writes never hold the device: an eager
    program or a §VI write-buffer group flush queues on the die program
    timelines and completes as a later ``prog_done`` event, contending
    with FIFO reads exactly like the deferred backlog it is;
  * **robustness tier** (armed by ``RunConfig`` fault knobs) — read
    bursts carry a per-command ``deadline_ns``; a burst that blows it
    raises a ``read_timeout`` event, and each timed-out request either
    re-admits at the NCQ *head* after a seeded exponential backoff
    (``backoff_base_ns * 2**(attempt-1)`` plus jitter from
    ``default_rng([seed, 0xB0FF, qi, attempt])``) or — past
    ``max_retries`` — completes with a typed ``CommandTimeoutError``
    flag.  ``hedge_quantile`` fires a duplicate (hedged) read once the
    burst's latency exceeds that quantile of prior burst latencies; the
    duplicate's work is charged to the flash timelines, and the request
    finishes at whichever copy wins.  ``shed_capacity`` bounds the
    overflow queue: arrivals beyond NCQ + shed complete immediately with
    a typed ``OverloadShedError`` flag instead of queueing unboundedly.
    Retries re-dispatch for *timing only* — the functional value was
    captured at first dispatch, so a retry can delay a result but never
    change it.  Pages whose primary chip is dead at service time are
    charged as replica ``degraded_reads`` on the failover chip, mirroring
    the sharded backend's routing.

The *functional* execution rides the same :class:`ReplayCore` as the
serial replay, invoked in dispatch order — so at
``RunConfig.event_serial()`` (one stream, zero inter-arrival, FIFO) the
backend sees the identical command sequence and the replay is
bit-identical to ``mode="serial"``.

Timing is deliberately backend-independent: the scalar backend gets the
same simulated clock as the sharded one, so load sweeps need no card.  The
per-burst resource accounting mirrors the sharded backend's ChipBurst
reports (unique pages -> senses + open-verification bus bytes; per read ->
match + bitmap + chunk payloads; per scan page -> one fused-plan match +
one 64 B bitmap).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.flash.params import (BITMAP_BYTES, CHUNK_BYTES,
                                      OPEN_OVERHEAD_BYTES, PAGE_BYTES)
from repro_torch.flash.timeline import BurstTimeline, ChipBurst
from repro_torch.workload.ycsb import Workload

from .arrivals import arrival_times
from .config import RunConfig
from .replay import ReplayCore
from .report import EnergyReport, LatencyReport, RunReport
from .scheduler import READ, make_scheduler

QUERY_BYTES = 16     # (query, mask) uint32 pairs shipped per search


@dataclasses.dataclass
class Request:
    """One workload op as an NCQ entry."""
    qi: int            # op index in the workload stream
    stream: int        # client stream (qi % concurrency)
    kind: int          # op code: 0 read, 1 write, 2 scan
    t_arrive: float    # arrival time, ns (admission wait counts from here)
    attempt: int = 0   # timeout re-admissions so far (robustness tier)
    served: bool = False   # functional value already captured (a retry
                           # re-dispatches for timing only, never re-executes)


class EventLoop:
    """Drives one ReplayCore through arrivals/NCQ/scheduler events."""

    def __init__(self, workload: Workload, backend, config: RunConfig):
        self.core = ReplayCore(workload, backend, config)
        self.config = config
        self.wl = workload
        self.n_chips = len(self.core.backend.chips.chips)
        # The frontend owns its clock: one BurstTimeline sized to the
        # backend's chip count, independent of any backend-attached
        # timeline (which, in event mode, is ignored).
        self.timeline = BurstTimeline.for_chips(self.n_chips)
        self.params = self.timeline.params
        self.sched = make_scheduler(config)
        # Robustness tier: the fault state is owned by the core (shared
        # with a fault-aware backend); this loop schedules its stall
        # windows onto the frontend timeline and fills its counters.
        self.fault_state = self.core.fault_state
        if self.fault_state is not None:
            self.timeline.attach_faults(self.fault_state)

        self.heap: list = []               # (t, seq, kind, payload)
        self._seq = 0
        self.ncq: list[Request] = []
        self.overflow: list[Request] = []
        self.inflight = 0                  # dispatched, not yet completed
        self.busy = False                  # a read/scan burst is in service
        self.n_done = 0
        self.t_last = 0.0
        self.read_lats: list[float] = []
        self.trace: list[tuple] = []
        self.events = self.dispatches = 0
        self.admitted = self.admission_waits = 0
        self.ncq_peak = 0

    # ------------------------------------------------------------ plumbing
    def _push(self, t: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self.heap, (t, self._seq, kind, payload))

    def _note(self, t: float, kind: str, qi: int) -> None:
        if self.config.record_trace:
            self.trace.append((t, kind, qi))

    def _depth(self) -> int:
        return len(self.ncq) + self.inflight

    def _note_peak(self) -> None:
        self.ncq_peak = max(self.ncq_peak, self._depth())

    def _admit(self, t: float) -> None:
        while self.overflow and self._depth() < self.config.ncq_depth:
            req = self.overflow.pop(0)
            self.ncq.append(req)
            self._note(t, "admit", req.qi)
            self._note_peak()

    def _complete(self, req: Request, t: float, *,
                  was_inflight: bool = True) -> None:
        if was_inflight:
            self.inflight -= 1
        if req.kind == READ:
            self.read_lats.append(t - req.t_arrive)
        self.n_done += 1
        self._note(t, "complete", req.qi)

    # -------------------------------------------------------------- events
    def _handle(self, t: float, kind: str, payload) -> None:
        if kind == "arrive":
            req: Request = payload
            self._note(t, "arrive", req.qi)
            cap = self.config.shed_capacity
            if self._depth() < self.config.ncq_depth:
                self.ncq.append(req)
                self.admitted += 1
                self._note_peak()
            elif cap is not None and len(self.overflow) >= cap:
                # Overload backpressure: refuse with a typed error rather
                # than queue unboundedly (OverloadShedError semantics).
                self.fault_state.stats.shed_requests += 1
                self.core.op_errors[req.qi] = True
                self.n_done += 1
                self._note(t, "shed", req.qi)
            else:
                self.overflow.append(req)
                self.admission_waits += 1
        elif kind == "read_done":
            for req in payload:
                self._complete(req, t)
            self.busy = False
        elif kind == "read_timeout":
            # The burst blew its deadline: every member either re-admits
            # after a seeded backoff or exhausts into a typed error.  The
            # device itself stays busy until burst_free — the timeout
            # frees the *client*, not the flash resources.
            st = self.fault_state.stats
            for req in payload:
                st.timeouts += 1
                self.inflight -= 1
                if req.attempt >= self.config.max_retries:
                    # CommandTimeoutError semantics: typed per-op error.
                    self.core.op_errors[req.qi] = True
                    self.n_done += 1
                    self._note(t, "timeout_error", req.qi)
                else:
                    req.attempt += 1
                    st.backoff_waits += 1
                    self._push(t + self._backoff_ns(req.qi, req.attempt),
                               "readmit", req)
            self._admit(t)
        elif kind == "burst_free":
            self.busy = False
        elif kind == "readmit":
            # Head re-admission: a retried command beats fresh queue
            # entries to the next burst (it has already waited longest).
            self.fault_state.stats.retries += 1
            self.ncq.insert(0, payload)
            self._note(t, "readmit", payload.qi)
            self._note_peak()
        elif kind == "scan_done":
            self._complete(payload, t)
            self.busy = False
        elif kind == "write_done":
            self._complete(payload, t)
        else:                              # prog_done: background program
            self._note(t, "prog_done", payload)

    # ---------------------------------------------------------- dispatching
    def _pump(self, t: float) -> None:
        """Admit waiting arrivals, then keep the device fed."""
        if self.fault_state is not None:
            self.fault_state.advance(t)    # fault clock follows dispatch
        self._admit(t)
        while not self.busy:
            if self.sched.pick_read(self.ncq) is not None:
                self._issue_reads(t)
                continue
            i = self.sched.pick(self.ncq)
            if i is None:
                return
            req = self.ncq.pop(i)
            if req.kind == 2:
                self._issue_scan(req, t)
            else:
                self._issue_write(req, t)

    def _issue_reads(self, t: float) -> None:
        """Compose and dispatch one read burst.

        Reads are pulled one at a time so an overlay-served read (a DRAM
        hit that never reaches the device) completes immediately, frees
        its NCQ slot, and lets the overflow backfill *within the same
        dispatch* — which is exactly how the serial replay fills bursts
        (overlay reads don't consume burst slots), and what keeps the
        concurrency-1 FIFO replay bit-identical.

        Buffered writes absorb into DRAM without touching the flash
        image, so — exactly as in the serial op loop — they are NOT
        burst barriers: a write the scheduler selects mid-burst executes
        inline and the pull continues.  The exception is a write that
        trips the high-water drain: its group flush reprograms flash, so
        queued reads must resolve first — it ends the burst (and runs
        after the read_done, which the serial ordering permits because
        nothing else can execute in between).
        """
        core, cfg = self.core, self.config
        batch: list[Request] = []
        n_retry = 0                        # re-dispatches (timing only)
        while len(core.pending) + n_retry < cfg.burst:
            i = self.sched.pick_read(self.ncq)
            if i is None:
                if not self._absorb_inline(t):
                    break
                continue
            req = self.ncq.pop(i)
            self._note(t, "dispatch", req.qi)
            if req.served:
                # A retried command: its value was captured at first
                # dispatch (reads are idempotent) — it joins the burst
                # for service timing only, never re-executes.
                batch.append(req)
                self.inflight += 1
                n_retry += 1
            elif core.queue_read(req.qi):
                req.served = True
                batch.append(req)
                self.inflight += 1
            else:
                self._complete(req, t + self.params.dram_hit_ns,
                               was_inflight=False)
                self._admit(t)
        if not batch:
            return
        lat = self.timeline.observe_flush(
            self._read_burst_counts(batch), at=t,
            wait_program_lines=self.sched.wait_program_lines)
        core.resolve_burst()
        self.dispatches += 1
        self.busy = True
        lat = self._maybe_hedge(batch, t, lat)
        deadline = cfg.deadline_ns
        if deadline is not None and lat > deadline:
            self._push(t + deadline, "read_timeout", batch)
            self._push(t + lat, "burst_free", None)
        else:
            self._push(t + lat, "read_done", batch)

    HEDGE_MIN_SAMPLES = 16     # burst-latency history before hedging arms

    def _backoff_ns(self, qi: int, attempt: int) -> float:
        """Exponential backoff with seeded jitter (deterministic per
        (seed, op, attempt) — same run, same waits, byte for byte)."""
        base = self.config.backoff_base_ns
        jitter = float(np.random.default_rng(
            [self.config.seed, 0xB0FF, qi, attempt]).random()) * base
        return base * (2.0 ** (attempt - 1)) + jitter

    def _maybe_hedge(self, batch: list[Request], t: float,
                     lat: float) -> float:
        """Fire a hedged duplicate of a slow burst; return effective lat.

        Once enough burst latencies have been observed, a burst slower
        than the ``hedge_quantile`` of the prior history dispatches a
        duplicate at ``t + hedge_delay``; the duplicate's senses, matches
        and bus bytes are charged to the flash timelines (no free
        recovery) and the batch completes at whichever copy finishes
        first.  ``hedges_won`` counts the duplicates that won.
        """
        q = self.config.hedge_quantile
        if q is None:
            return lat
        hist = self.timeline.burst_latencies
        if len(hist) <= self.HEDGE_MIN_SAMPLES:   # history excludes current
            return lat
        delay = float(np.percentile(np.asarray(hist[:-1]), q * 100.0))
        if lat <= delay:
            return lat
        hedge_lat = self.timeline.observe_flush(
            self._read_burst_counts(batch), at=t + delay,
            wait_program_lines=self.sched.wait_program_lines)
        if delay + hedge_lat < lat:
            self.fault_state.stats.hedges_won += 1
            return delay + hedge_lat
        return lat

    def _absorb_inline(self, t: float) -> bool:
        """Mid-burst: execute the next write inline iff it only absorbs.

        Returns True when a buffered, non-tripping write was consumed
        (the read pull continues); False when the burst must end — no
        write selectable, eager-program mode (a write is a read-your-
        writes barrier there), or the write would trip the high-water
        group drain.
        """
        core = self.core
        if core.wb is None:
            return False
        i = self.sched.pick(self.ncq)
        if i is None or self.ncq[i].kind != 1:
            return False
        qi = self.ncq[i].qi
        if core.wb.would_trip(int(self.wl.value_pages[qi])):
            return False
        self._issue_write(self.ncq.pop(i), t)
        return True

    def _route_chip(self, page: int) -> tuple[int, bool]:
        """Chip serving ``page`` now: the primary, or — primary dead —
        the first live replica chip, mirroring the sharded backend's
        ``(chip + r) % n`` replica striping.  Returns (chip, degraded)."""
        chip = page % self.n_chips
        if self.fault_state is None or not self.fault_state.chip_dead(chip):
            return chip, False
        for r in range(1, getattr(self.core.backend, "replicas", 1)):
            c = (chip + r) % self.n_chips
            if not self.fault_state.chip_dead(c):
                return c, True
        return chip, False     # no live replica: the op fails typed anyway

    def _read_burst_counts(self, batch: list[Request]) -> list[ChipBurst]:
        """Per-chip resource counts of one read burst (see module doc).

        A page whose primary chip is dead charges a full-page degraded
        read on its failover chip (the host-side path moves the whole
        page) instead of in-flash match work.
        """
        bursts: dict[int, ChipBurst] = {}

        def b(chip: int) -> ChipBurst:
            return bursts.setdefault(chip, ChipBurst(chip))

        opened: set[int] = set()
        degraded: set[int] = set()
        for req in batch:
            kp = int(self.wl.key_pages[req.qi])
            vp = int(self.wl.value_pages[req.qi])
            for p in (kp, vp):              # page opens amortize per burst
                if p in opened:
                    continue
                opened.add(p)
                chip, is_degraded = self._route_chip(p)
                cb = b(chip)
                if is_degraded:
                    degraded.add(p)
                    cb.degraded_reads += 1
                    cb.pcie_bytes += PAGE_BYTES
                else:
                    cb.senses += 1
                    cb.bus_match_bytes += OPEN_OVERHEAD_BYTES
            if kp not in degraded:          # degraded pages match host-side
                kb = b(kp % self.n_chips)
                kb.matches += 1
                kb.bus_match_bytes += BITMAP_BYTES
                kb.pcie_bytes += BITMAP_BYTES + QUERY_BYTES
            if vp not in degraded:          # speculative value-page gather
                vb = b(vp % self.n_chips)
                vb.bus_match_bytes += CHUNK_BYTES
                vb.pcie_bytes += CHUNK_BYTES
        return [bursts[c] for c in sorted(bursts)]

    def _issue_scan(self, req: Request, t: float) -> None:
        self._note(t, "dispatch", req.qi)
        self.dispatches += 1
        pages = self.core.scan(req.qi)     # functional execution
        bursts: dict[int, ChipBurst] = {}
        for p in pages:                    # fused plan: one 64 B per page
            cb = bursts.setdefault(p % self.n_chips,
                                   ChipBurst(p % self.n_chips))
            cb.senses += 1
            cb.matches += 1
            cb.bus_match_bytes += BITMAP_BYTES
            cb.pcie_bytes += BITMAP_BYTES
        if bursts:
            lat = self.timeline.observe_flush(
                [bursts[c] for c in sorted(bursts)], at=t,
                wait_program_lines=self.sched.wait_program_lines)
        else:
            lat = self.params.mmio_ns      # empty range: command rtt only
        self.inflight += 1
        self.busy = True
        self._push(t + lat, "scan_done", req)

    def _program_group_chips(self, pages: list[int]) -> list[int]:
        """Chips a program group lands on: every page's primary and, on a
        replicated backend, its mirror chips ((chip + r) % n striping)."""
        reps = getattr(self.core.backend, "replicas", 1)
        return [(p + r) % self.n_chips for p in pages for r in range(reps)]

    def _issue_write(self, req: Request, t: float) -> None:
        """Execute a write; its program cost runs in the background."""
        self._note(t, "dispatch", req.qi)
        self.dispatches += 1
        kind, pages = self.core.write(req.qi)
        # Replicated backends program every mirror chip, so the frontend
        # timeline charges them all; prog_done tracks the primary program.
        reps = getattr(self.core.backend, "replicas", 1)
        if kind == "program":              # eager per-write program
            for pg in pages:
                for r in range(reps):
                    lat = self.timeline.observe_program(
                        (pg + r) % self.n_chips, at=t)
                    if r == 0:
                        self._push(t + lat, "prog_done", pg)
            done = t + self.params.mmio_ns
        elif kind == "flush":              # high-water group drain
            chips = self._program_group_chips(pages)
            lats = self.timeline.observe_program_group(
                chips, restage_chips=chips, at=t)
            for pg, lat in zip(pages, lats[::reps]):
                self._push(t + lat, "prog_done", pg)
            done = t + self.params.dram_hit_ns
        else:                              # absorbed into the DRAM buffer
            done = t + self.params.dram_hit_ns
        self.inflight += 1
        self._push(done, "write_done", req)

    # ----------------------------------------------------------------- run
    def run(self) -> RunReport:
        n = len(self.wl.ops)
        times, streams = arrival_times(self.config, n)
        for qi in range(n):
            self._push(float(times[qi]), "arrive",
                       Request(qi, int(streams[qi]), int(self.wl.ops[qi]),
                               float(times[qi])))
        while self.heap:
            t = self.heap[0][0]
            # Drain every event at this timestamp before scheduling, so a
            # zero-inter-arrival backlog is visible as one batch (parity
            # with the serial replay) and ties stay deterministic.
            while self.heap and self.heap[0][0] == t:
                _, _, kind, payload = heapq.heappop(self.heap)
                self.events += 1
                self._handle(t, kind, payload)
            self.t_last = t
            self._pump(t)
        if self.n_done != n:
            raise RuntimeError(
                f"event loop drained with {self.n_done}/{n} ops complete")
        # End of stream: the final write-buffer drain + reliability
        # refreshes happen "after" the last event, like the serial finish.
        pages = self.core.finish()
        if pages:
            chips = self._program_group_chips(pages)
            self.timeline.observe_program_group(chips, restage_chips=chips,
                                                at=self.t_last)
        return self._report()

    def _report(self) -> RunReport:
        rep = self.core.report("event")
        tl = self.timeline
        makespan = max(tl.now, self.t_last)
        rep.latency = LatencyReport.from_read_latencies(
            self.read_lats, makespan_ns=makespan, n_ops=len(self.wl.ops),
            burst_latencies_ns=np.asarray(tl.burst_latencies),
            write_latencies_ns=np.asarray(tl.write_latencies))
        rep.energy = EnergyReport(total_pj=tl.energy_pj)
        c = rep.counters
        c.events = self.events
        c.dispatches = self.dispatches
        c.admitted = self.admitted
        c.admission_waits = self.admission_waits
        c.ncq_peak = self.ncq_peak
        rep.trace = tuple(self.trace)
        return rep
