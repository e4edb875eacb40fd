"""The functional execution core, shared by the serial and event replays.

:class:`ReplayCore` holds everything stateful about one replay — the host
value mirror, the pending read burst, the depth-1 lazy drain pipeline and
the DRAM write buffer — and each replay loop owns only the question "when
does the next op execute":

  * :func:`replay` with ``mode="serial"`` iterates the op stream in order:
    reads accumulate to ``burst``; eager writes and scans are barriers, a
    buffered write is not;
  * :mod:`repro_torch.frontend.eventloop` (``mode="event"``) admits ops
    through a bounded NCQ and lets a scheduler policy compose the bursts;
    at one stream, zero inter-arrival and FIFO it degenerates to the
    serial order and replays bit-identically.

A backend with a flash timeline (the sharded backend's ``timeline=True``)
measures the replayed op stream: the timeline is reset after the bulk load
and the report carries its burst and write latencies, makespan and energy.
With ``config.reliability`` the loaded pages are fault-injected and every
flush runs the §IV-C pipeline (typed per-op errors in
``report.reliability``, stale pages refreshed at the end); with any fault
knob set a ``DeviceFaultState`` attaches to the backend after the load
(``report.faults``).  Results are bit-identical to the JAX package's
replay on the same workload.
"""
from __future__ import annotations

import numpy as np

from repro_torch import spans
from repro_torch.backend.base import MatchBackend, as_backend
from repro_torch.buffer.writebuffer import WriteBuffer
from repro_torch.core.bits import SLOTS_PER_CHUNK, unpack_bitmap
from repro_torch.core.commands import Command
from repro_torch.core.page import mask_header_slots
from repro_torch.core.range_query import evaluate_plan_on_pages, exact_range
from repro_torch.core.page import entries_from_plain
from repro_torch.reliability import (DegradedReadError, DeviceFaultState,
                                     FaultSchedule, UncorrectableReadError,
                                     require_clean)
from repro_torch.workload.ycsb import KEYS_PER_PAGE, Workload, value_page_of

from .config import RunConfig
from .report import (CounterReport, EnergyReport, FaultReport,
                     LatencyReport, ReliabilityReport, RunReport)

FULL_MASK = 0xFFFFFFFFFFFFFFFF


class ReplayCore:
    """Executes one workload's ops against a MatchBackend.

    Key id ``k`` lives on key page ``k // 504`` at entry ``k % 504`` with
    stored key ``k + 1`` (nonzero, distinct from the vacant-slot
    sentinel); its value sits at the same entry of the §V-A paired value
    page.  See :func:`replay` for the path semantics.
    """

    def __init__(self, workload: Workload, backend: MatchBackend,
                 config: RunConfig):
        if workload.keys is None:
            raise ValueError("workload has no key stream "
                             "(regenerate with ycsb.generate)")
        self.workload = workload
        self.config = config
        # A bare SimChipArray runs on the scalar reference backend.
        self.backend = backend = as_backend(backend)
        self.n_key_pages = workload.n_index_pages // 2
        self.n_keys = self.n_key_pages * KEYS_PER_PAGE
        self.stored_keys = np.arange(1, self.n_keys + 1, dtype=np.uint64)
        # Deterministic initial values (odd, so never the vacant sentinel).
        self.values = (self.stored_keys * np.uint64(0x9E3779B97F4A7C15)) \
            | np.uint64(1)

        for p in range(self.n_key_pages):
            s = p * KEYS_PER_PAGE
            backend.program_entries(
                p, self.stored_keys[s:s + KEYS_PER_PAGE])
            backend.program_entries(
                value_page_of(p, self.n_key_pages),
                self.values[s:s + KEYS_PER_PAGE])

        # Fault injection corrupts the images loaded above (install also
        # switches every later flush onto the reliability path).
        self.reliability = config.reliability
        if self.reliability is not None:
            self.reliability.install(backend)

        # Device-fault tier: outages/stalls/program failures attach AFTER
        # the bulk load (the load is setup — a chip dead at t=0 keeps its
        # loaded image and is served via replicas from the first real op).
        self.fault_state = None
        if (config.faults is not None or config.deadline_ns is not None
                or config.hedge_quantile is not None
                or config.shed_capacity is not None):
            self.fault_state = DeviceFaultState(
                config.faults or FaultSchedule.healthy(seed=config.seed))
            if hasattr(backend, "enable_device_faults"):
                backend.enable_device_faults(self.fault_state)

        # Timeline-coupled backends (sharded + BurstTimeline) measure the
        # replayed op stream only — the bulk load is setup, not workload.
        self.timeline = getattr(backend, "timeline", None)
        if self.timeline is not None:
            self.timeline.reset()

        wb = config.write_buffer
        if wb is True:
            wb = WriteBuffer(high_water=config.write_high_water)
        self.wb: WriteBuffer | None = wb or None

        n = len(workload.ops)
        self.out = np.zeros(n, dtype=np.uint64)
        self.hits = np.zeros(n, dtype=bool)
        self.read_errors = np.zeros(n, dtype=bool)
        self.op_errors = np.zeros(n, dtype=bool)   # fault-tier typed errors
        self.scan_counts = np.zeros(n, dtype=np.int64)
        self.flushes = 0
        self.n_reads = self.n_writes = self.n_scans = 0
        self.programs = self.write_flushes = 0
        self.refreshes = 0
        self.pending: list[int] = []        # op indices of queued reads
        self._inflight: list[list] = []     # flushed, not-yet-drained bursts

    # -------------------------------------------------------------- reads
    def queue_read(self, qi: int) -> bool:
        """Queue read op ``qi`` into the open burst.

        Returns False when the read was served from the write-buffer
        overlay instead (read-your-writes from DRAM: a dirty value page
        answers straight from the buffered image — no device command;
        key pages are never written, so a buffered value page always
        implies the key exists on its key page).
        """
        s = spans.ON and spans.begin("frontend.read")
        try:
            self.n_reads += 1
            if self.wb is not None:
                overlay = self.wb.get(int(self.workload.value_pages[qi]))
                if overlay is not None:
                    k = int(self.workload.keys[qi])
                    self.out[qi] = overlay[k % KEYS_PER_PAGE]
                    self.hits[qi] = True
                    return False
            self.pending.append(qi)
            return True
        finally:
            if s:
                spans.end(s)

    def resolve_burst(self) -> None:
        """Flush the open read burst (no-op when nothing is pending).

        Picks the path per call rather than storing a bound method: that
        would make the core a reference cycle and keep the backend's
        device arena alive after the replay until the garbage collector
        runs.
        """
        s = spans.ON and spans.begin("frontend.burst")
        try:
            if self.config.fused:
                self._resolve_burst_fused()
            else:
                self._resolve_burst_split()
        finally:
            if s:
                spans.end(s)

    def _drain(self, lookups) -> None:
        s = spans.ON and spans.begin("frontend.drain")
        try:
            for qi, t in lookups:
                try:
                    r = require_clean(t.result())
                except UncorrectableReadError:
                    self.read_errors[qi] = True
                    continue
                except DegradedReadError:
                    self.op_errors[qi] = True   # no live replica left
                    continue
                if r.value_slot is None:
                    continue
                self.out[qi] = int.from_bytes(r.value, "little")
                self.hits[qi] = True
        finally:
            if s:
                spans.end(s)

    def drain_inflight(self) -> None:
        while self._inflight:
            self._drain(self._inflight.pop(0))

    def _resolve_burst_fused(self) -> None:
        """One submit_lookup per read: the whole burst is ONE launch.

        The flush only *dispatches* the launch; this burst's host tail is
        deferred until the NEXT burst has been flushed (depth-1 pipeline),
        so staging of burst k+1 overlaps device compute of burst k.
        Results are position-tagged, so the deferred drain is
        order-independent and bit-identical.
        """
        if not self.pending:
            return
        wl, backend = self.workload, self.backend
        lookups = [(qi, backend.submit_lookup(Command.lookup(
            int(wl.key_pages[qi]), int(wl.value_pages[qi]),
            int(self.stored_keys[wl.keys[qi]]), FULL_MASK)))
            for qi in self.pending]
        self.pending.clear()
        backend.flush()
        self.flushes += 1
        self._inflight.append(lookups)
        while len(self._inflight) > 1:
            self._drain(self._inflight.pop(0))

    def _resolve_burst_split(self) -> None:
        """Search launch, host bitmap decode, then gather launch."""
        if not self.pending:
            return
        wl, backend = self.workload, self.backend
        searches = [(qi, backend.submit_search(Command.search(
            int(wl.key_pages[qi]),
            int(self.stored_keys[wl.keys[qi]]), FULL_MASK)))
            for qi in self.pending]
        self.pending.clear()
        backend.flush()
        self.flushes += 1
        gathers = []
        for qi, t in searches:
            try:
                bitmap = mask_header_slots(
                    require_clean(t.result()).bitmap_words)
            except UncorrectableReadError:
                self.read_errors[qi] = True
                continue
            except DegradedReadError:
                self.op_errors[qi] = True
                continue
            slots = np.nonzero(unpack_bitmap(bitmap, 512))[0]
            if slots.size == 0:
                continue
            value_slot = int(slots[0])      # same entry on the value page
            gathers.append((qi, value_slot, backend.submit_gather(
                Command.gather(int(wl.value_pages[qi]),
                               1 << (value_slot // SLOTS_PER_CHUNK)))))
        backend.flush()
        self.flushes += 1
        for qi, value_slot, g in gathers:
            off = (value_slot % SLOTS_PER_CHUNK) * 8
            try:
                r = require_clean(g.result())
            except UncorrectableReadError:
                self.read_errors[qi] = True
                continue
            except DegradedReadError:
                self.op_errors[qi] = True
                continue
            self.out[qi] = int.from_bytes(
                bytes(r.chunks[0][off:off + 8]), "little")
            self.hits[qi] = True

    # -------------------------------------------------------------- scans
    def scan_pages(self, qi: int) -> list[int]:
        """Key pages scan op ``qi`` touches."""
        wl = self.workload
        k = int(wl.keys[qi])
        lo = k + 1
        hi = min(lo + int(wl.scan_lens[qi]), self.n_keys + 1)
        if lo >= hi:
            return []
        p0 = (lo - 1) // KEYS_PER_PAGE     # page of stored key lo
        p1 = (hi - 2) // KEYS_PER_PAGE     # page of stored key hi - 1
        return list(range(p0, min(p1, self.n_key_pages - 1) + 1))

    def scan(self, qi: int) -> list[int]:
        """YCSB-E scan: ONE Op.PLAN per touched key page, fused in-latch.

        Scans key ids [k, k + len); stored key of id k is k + 1, and ids
        are laid out contiguously (page p holds ids [p*504, (p+1)*504)),
        so the plan only needs the pages overlapping the stored-key range
        [lo, hi).  Key pages are never reprogrammed, so a scan needs no
        ordering against the write stream — only the open read burst is
        resolved first so the plan flush stays a dedicated launch.
        Returns the touched pages (the event loop's timing footprint).
        """
        s = spans.ON and spans.begin("frontend.scan")
        try:
            return self._scan(qi)
        finally:
            if s:
                spans.end(s)

    def _scan(self, qi: int) -> list[int]:
        self.resolve_burst()
        wl = self.workload
        pages = self.scan_pages(qi)
        if not pages:
            return pages
        k = int(wl.keys[qi])
        lo = k + 1
        hi = min(lo + int(wl.scan_lens[qi]), self.n_keys + 1)
        s = spans.ON and spans.begin("frontend.scan.plan")
        plan = exact_range(lo, hi, width=64)
        if s:
            spans.end(s)
        try:
            bitmaps = evaluate_plan_on_pages(self.backend, plan, pages)
        except UncorrectableReadError:
            # Any touched page failing outer-code decode voids the whole
            # scan — a partial count would be a silently wrong result.
            self.read_errors[qi] = True
            self.flushes += 1
            self.n_scans += 1
            return pages
        except DegradedReadError:
            self.op_errors[qi] = True
            self.flushes += 1
            self.n_scans += 1
            return pages
        self.flushes += 1
        total = 0
        for bm in bitmaps:
            bits = unpack_bitmap(mask_header_slots(bm), 512)
            total += int(bits.sum())
        self.scan_counts[qi] = total
        self.n_scans += 1
        return pages

    # ------------------------------------------------------------- writes
    def write(self, qi: int) -> tuple[str, list[int]]:
        """Execute write op ``qi``: an eager per-write program, or — with
        the DRAM buffer — an absorbed write that drains the dirty set as
        one deferred-program group when it reaches the high-water mark.

        Returns the device-side effect for the event loop's timing
        model: ``("program", [page])`` for an eager program, ``("absorb",
        [])`` when the buffer swallowed it, or ``("flush", pages)`` when
        it tripped the high-water mark and the listed pages drained.
        """
        s = spans.ON and spans.begin("frontend.write")
        try:
            return self._write(qi)
        finally:
            if s:
                spans.end(s)

    def _write(self, qi: int) -> tuple[str, list[int]]:
        self.n_writes += 1
        wl = self.workload
        k = int(wl.keys[qi])
        self.values[k] = np.uint64(qi * 2 + 1)   # tagged by op index, odd
        p = k // KEYS_PER_PAGE
        s = p * KEYS_PER_PAGE
        vpage = value_page_of(p, self.n_key_pages)
        if self.wb is not None:
            # Absorb into the DRAM buffer; the on-flash image stays as
            # queued reads expect it until the grouped flush below.
            self.wb.put(vpage, self.values[s:s + KEYS_PER_PAGE])
            if self.wb.should_flush:
                return "flush", self.flush_write_buffer()
            return "absorb", []
        self.resolve_burst()                # read-your-writes ordering
        if self.reliability is not None:
            # The reliability finalize verifies hits against the on-flash
            # image at RESOLVE time (selective verification is a re-read,
            # not a kernel output), so the image must not change under an
            # in-flight burst: drain the depth-1 pipeline before
            # reprogramming.
            self.drain_inflight()
        self.backend.program_entries(
            vpage, self.values[s:s + KEYS_PER_PAGE])
        self.programs += 1
        return "program", [vpage]

    def flush_write_buffer(self) -> list[int]:
        """Drain the dirty set as ONE deferred-program group; returns the
        programmed pages (empty when the buffer was clean)."""
        if self.wb is None or not self.wb.n_dirty:
            return []
        self.resolve_burst()        # queued reads precede the programs
        if self.reliability is not None:
            self.drain_inflight()
        pages = self.wb.dirty_pages
        self.programs += self.wb.flush(self.backend)
        self.write_flushes += 1
        return pages

    # ------------------------------------------------------------- finish
    def finish(self) -> list[int]:
        """End of stream: final burst, final buffer drain, full drain and
        reliability refreshes.  Returns the final program group's pages."""
        self.resolve_burst()
        pages = self.flush_write_buffer()
        self.drain_inflight()
        if self.reliability is not None:
            self.refreshes = _drain_refreshes(self.backend,
                                              self.reliability)
        return pages

    # ------------------------------------------------------------- report
    def report(self, source: str) -> RunReport:
        stats = self.backend.stats
        rep = RunReport(
            source=source,
            read_values=self.out, read_hits=self.hits,
            scan_counts=self.scan_counts if self.n_scans else None,
            counters=CounterReport(
                reads=self.n_reads, writes=self.n_writes,
                scans=self.n_scans, flushes=self.flushes,
                kernel_launches=stats.kernel_launches,
                staged_bytes=stats.staged_bytes,
                result_bytes=stats.result_bytes,
                programs=self.programs, write_flushes=self.write_flushes,
                buffer_read_hits=(self.wb.stats.read_hits
                                  if self.wb is not None else 0)),
            reliability=ReliabilityReport(
                read_errors=(self.read_errors
                             if self.reliability is not None else None),
                n_read_errors=int(self.read_errors.sum()),
                refreshes=self.refreshes,
                stats=(self.reliability.stats
                       if self.reliability is not None else None)))
        if self.fault_state is not None:
            fs = self.fault_state.stats
            rep.faults = FaultReport(
                timeouts=fs.timeouts, retries=fs.retries,
                backoff_waits=fs.backoff_waits, hedges_won=fs.hedges_won,
                failovers=fs.failovers,
                remapped_blocks=fs.remapped_blocks,
                degraded_ops=fs.degraded_ops,
                shed_requests=fs.shed_requests,
                replica_programs=fs.replica_programs,
                program_failures=fs.program_failures,
                op_errors=self.op_errors,
                n_op_errors=int(self.op_errors.sum()))
        if self.timeline is not None:
            rep.latency = LatencyReport(
                burst_latencies_ns=np.asarray(
                    self.timeline.burst_latencies),
                write_latencies_ns=np.asarray(
                    self.timeline.write_latencies),
                makespan_ns=self.timeline.now)
            rep.energy = EnergyReport(total_pj=self.timeline.energy_pj)
        return rep


def _drain_refreshes(backend, reliability) -> int:
    """Rewrite every page the open bursts flagged CLEAN_NEEDS_REFRESH.

    A refresh is read-through-ECC then reprogram: sub-threshold raw errors
    are corrected (the simulator's ``_repair`` restores the clean image),
    the entries are re-extracted and ride the deferred ``Op.PROGRAM`` path
    with a fresh timestamp — so the rewrite groups and coalesces exactly
    like workload writes and later opens see a young, error-free page.
    Pages whose raw error count exceeds the outer-code budget cannot be
    refreshed (the data is gone); they stay marked and keep surfacing as
    typed errors.
    """
    chips = backend.chips
    tickets = []
    for addr in sorted(reliability.refresh_due):
        chip, local = chips.route(addr)
        sp = chip.pages.get(local)
        if sp is None:
            continue
        if sp.injected_error_bits > reliability.policy.ecc.t_correctable:
            continue                       # beyond refresh: uncorrectable
        if sp.injected_error_bits:
            reliability.stats.corrected_bits += sp.injected_error_bits
            chip._repair(sp, local)
        plain = chip._derandomize_page(sp, local)
        entries = entries_from_plain(plain, sp.n_entries)
        tickets.append(backend.submit_program(
            addr, entries, timestamp_ns=reliability.now_ns))
    if tickets:
        backend.flush()
    reliability.refresh_due.clear()
    reliability.stats.refreshes += len(tickets)
    return len(tickets)


def replay(workload: Workload, backend: MatchBackend,
           config: RunConfig = RunConfig()) -> RunReport:
    """Execute the op stream against real pages through a MatchBackend.

    Reads accumulate into bursts of up to ``config.burst`` queries.  With
    ``fused=False`` the burst's searches flush as one batch, then its value
    gathers as a second — two kernel launches on the batched backend.  With
    ``fused=True`` every read becomes a ``submit_lookup`` and the whole
    burst resolves in one fused launch, with the depth-1 lazy pipeline
    overlapping adjacent bursts.  Writes are eager per-write programs that
    first resolve the open burst (read-your-writes), or — with
    ``write_buffer`` — absorb into the §VI DRAM buffer, serve overlay
    reads, and drain in grouped deferred-program bursts at the high-water
    mark.  Scans (``ops == 2``) replay as fused Op.PLAN bursts, one flush
    a scan.  With a ``reliability`` state attached the replay runs against
    fault-injected pages and per-op errors surface in
    ``report.reliability``; with a fault schedule or robustness knob, the
    device-fault counters and typed per-op errors are in ``report.faults``.

    ``config.mode == "event"`` runs the event-loop simulator instead: ops
    *arrive* (Poisson, trace or all at zero), queue in a bounded NCQ, and
    a scheduler policy composes the device bursts; the report also
    carries the per-request simulated latency distribution and admission
    counters.  At ``RunConfig.event_serial()`` the replay is
    bit-identical to the serial one.
    """
    if config.mode == "event":
        from .eventloop import EventLoop
        return EventLoop(workload, backend, config).run()
    core = ReplayCore(workload, backend, config)
    wl = workload
    for qi in range(len(wl.ops)):
        if wl.ops[qi] == 0:
            if core.queue_read(qi) and len(core.pending) >= config.burst:
                core.resolve_burst()
        elif wl.ops[qi] == 2:
            core.scan(qi)
        else:
            core.write(qi)
    core.finish()
    return core.report("serial")
