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
    with FIFO reads exactly like the deferred backlog it is.

The robustness tier of the JAX package's event loop — per-read deadlines
with seeded-backoff retries, hedged reads, overload shedding and the
device-fault hooks — comes with slice 7 of the port; its ``RunConfig``
knobs raise until then.

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
                                      OPEN_OVERHEAD_BYTES)
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
            if self._depth() < self.config.ncq_depth:
                self.ncq.append(req)
                self.admitted += 1
                self._note_peak()
            else:
                self.overflow.append(req)
                self.admission_waits += 1
        elif kind == "read_done":
            for req in payload:
                self._complete(req, t)
            self.busy = False
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
        while len(core.pending) < cfg.burst:
            i = self.sched.pick_read(self.ncq)
            if i is None:
                if not self._absorb_inline(t):
                    break
                continue
            req = self.ncq.pop(i)
            self._note(t, "dispatch", req.qi)
            if core.queue_read(req.qi):
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
        self._push(t + lat, "read_done", batch)

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

    def _read_burst_counts(self, batch: list[Request]) -> list[ChipBurst]:
        """Per-chip resource counts of one read burst (see module doc)."""
        bursts: dict[int, ChipBurst] = {}

        def b(chip: int) -> ChipBurst:
            return bursts.setdefault(chip, ChipBurst(chip))

        opened: set[int] = set()
        for req in batch:
            kp = int(self.wl.key_pages[req.qi])
            vp = int(self.wl.value_pages[req.qi])
            for p in (kp, vp):              # page opens amortize per burst
                if p in opened:
                    continue
                opened.add(p)
                cb = b(p % self.n_chips)
                cb.senses += 1
                cb.bus_match_bytes += OPEN_OVERHEAD_BYTES
            kb = b(kp % self.n_chips)
            kb.matches += 1
            kb.bus_match_bytes += BITMAP_BYTES
            kb.pcie_bytes += BITMAP_BYTES + QUERY_BYTES
            vb = b(vp % self.n_chips)       # speculative value-page gather
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
        # End of stream: the final write-buffer drain happens "after" the
        # last event, like the serial finish.
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
