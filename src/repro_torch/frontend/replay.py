"""The functional execution core and the serial replay driver.

:class:`ReplayCore` holds everything stateful about one replay — the host
value mirror, the pending read burst, the depth-1 lazy drain pipeline and
the DRAM write buffer — and :func:`replay` iterates the op stream in order:
reads accumulate to ``burst``; eager writes and scans are barriers, a
buffered write is not.  Results are bit-identical to the JAX package's
serial replay on the same workload.

Not ported yet, and refused by :class:`~repro_torch.frontend.config.RunConfig`:
the event-driven driver and the reliability and device-fault tiers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.backend.base import MatchBackend
from repro_torch.buffer.writebuffer import WriteBuffer
from repro_torch.core.bits import SLOTS_PER_CHUNK, unpack_bitmap
from repro_torch.core.commands import Command
from repro_torch.core.page import mask_header_slots
from repro_torch.core.range_query import evaluate_plan_on_pages, exact_range
from repro_torch.reliability import (DegradedReadError,
                                     UncorrectableReadError, require_clean)
from repro_torch.workload.ycsb import KEYS_PER_PAGE, Workload, value_page_of

from .config import RunConfig
from .report import CounterReport, ReliabilityReport, RunReport

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
        if not isinstance(backend, MatchBackend):
            raise NotImplementedError(
                "replay needs a MatchBackend; wrapping a bare SimChipArray "
                "in the scalar reference backend is slice 5 of the port")
        self.workload = workload
        self.config = config
        self.backend = backend
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

        wb = config.write_buffer
        if wb is True:
            wb = WriteBuffer(high_water=config.write_high_water)
        self.wb: WriteBuffer | None = wb or None

        n = len(workload.ops)
        self.out = np.zeros(n, dtype=np.uint64)
        self.hits = np.zeros(n, dtype=bool)
        self.read_errors = np.zeros(n, dtype=bool)
        self.op_errors = np.zeros(n, dtype=bool)
        self.scan_counts = np.zeros(n, dtype=np.int64)
        self.flushes = 0
        self.n_reads = self.n_writes = self.n_scans = 0
        self.programs = self.write_flushes = 0
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

    def resolve_burst(self) -> None:
        """Flush the open read burst (no-op when nothing is pending).

        Picks the path per call rather than storing a bound method: that
        would make the core a reference cycle and keep the backend's
        device arena alive after the replay until the garbage collector
        runs.
        """
        if self.config.fused:
            self._resolve_burst_fused()
        else:
            self._resolve_burst_split()

    def _drain(self, lookups) -> None:
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

    def scan(self, qi: int) -> None:
        """YCSB-E scan: ONE Op.PLAN per touched key page, fused in-latch.

        Scans key ids [k, k + len); stored key of id k is k + 1, and ids
        are laid out contiguously (page p holds ids [p*504, (p+1)*504)),
        so the plan only needs the pages overlapping the stored-key range
        [lo, hi).  Key pages are never reprogrammed, so a scan needs no
        ordering against the write stream — only the open read burst is
        resolved first so the plan flush stays a dedicated launch.
        """
        self.resolve_burst()
        wl = self.workload
        pages = self.scan_pages(qi)
        if not pages:
            return
        k = int(wl.keys[qi])
        lo = k + 1
        hi = min(lo + int(wl.scan_lens[qi]), self.n_keys + 1)
        try:
            bitmaps = evaluate_plan_on_pages(
                self.backend, exact_range(lo, hi, width=64), pages)
        except UncorrectableReadError:
            # Any touched page failing outer-code decode voids the whole
            # scan — a partial count would be a silently wrong result.
            self.read_errors[qi] = True
            self.flushes += 1
            self.n_scans += 1
            return
        except DegradedReadError:
            self.op_errors[qi] = True
            self.flushes += 1
            self.n_scans += 1
            return
        self.flushes += 1
        total = 0
        for bm in bitmaps:
            bits = unpack_bitmap(mask_header_slots(bm), 512)
            total += int(bits.sum())
        self.scan_counts[qi] = total
        self.n_scans += 1

    # ------------------------------------------------------------- writes
    def write(self, qi: int) -> None:
        """Execute write op ``qi``: an eager per-write program, or — with
        the DRAM buffer — an absorbed write that drains the dirty set as
        one deferred-program group when it reaches the high-water mark."""
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
                self.flush_write_buffer()
            return
        self.resolve_burst()                # read-your-writes ordering
        self.backend.program_entries(
            vpage, self.values[s:s + KEYS_PER_PAGE])
        self.programs += 1

    def flush_write_buffer(self) -> None:
        """Drain the dirty set as ONE deferred-program group (a no-op when
        the buffer is clean)."""
        if self.wb is None or not self.wb.n_dirty:
            return
        self.resolve_burst()        # queued reads precede the programs
        self.programs += self.wb.flush(self.backend)
        self.write_flushes += 1

    # ------------------------------------------------------------- finish
    def finish(self) -> None:
        """End of stream: final burst, final buffer drain, full drain."""
        self.resolve_burst()
        self.flush_write_buffer()
        self.drain_inflight()

    # ------------------------------------------------------------- report
    def report(self, source: str) -> RunReport:
        stats = self.backend.stats
        return RunReport(
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
                n_read_errors=int(self.read_errors.sum())))


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
    a scan.
    """
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
