"""The functional execution core and the serial replay driver.

:class:`ReplayCore` holds everything stateful about one replay — the host
value mirror, the pending read burst and the depth-1 lazy drain pipeline —
and :func:`replay` iterates the op stream in order: reads accumulate to
``burst``, writes are barriers.  Results are bit-identical to the JAX
package's serial replay on the same workload.

Not ported yet, and refused by :class:`~repro_torch.frontend.config.RunConfig`
or here: the event-driven driver, the DRAM write buffer, YCSB-E scans
(``ops == 2``), and the reliability and device-fault tiers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.backend.base import MatchBackend
from repro_torch.core.bits import SLOTS_PER_CHUNK, unpack_bitmap
from repro_torch.core.commands import Command
from repro_torch.core.page import mask_header_slots
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
                "in the scalar reference backend is slice 3 of the port")
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

        n = len(workload.ops)
        self.out = np.zeros(n, dtype=np.uint64)
        self.hits = np.zeros(n, dtype=bool)
        self.read_errors = np.zeros(n, dtype=bool)
        self.op_errors = np.zeros(n, dtype=bool)
        self.flushes = 0
        self.n_reads = self.n_writes = 0
        self.programs = 0
        self.pending: list[int] = []        # op indices of queued reads
        self._inflight: list[list] = []     # flushed, not-yet-drained bursts
        self._resolve = (self._resolve_burst_fused if config.fused
                         else self._resolve_burst_split)

    # -------------------------------------------------------------- reads
    def queue_read(self, qi: int) -> None:
        """Queue read op ``qi`` into the open burst."""
        self.n_reads += 1
        self.pending.append(qi)

    def resolve_burst(self) -> None:
        """Flush the open read burst (no-op when nothing is pending)."""
        self._resolve()

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

    # ------------------------------------------------------------- writes
    def write(self, qi: int) -> None:
        """Execute write op ``qi`` as an eager per-write program."""
        self.n_writes += 1
        wl = self.workload
        k = int(wl.keys[qi])
        self.values[k] = np.uint64(qi * 2 + 1)   # tagged by op index, odd
        p = k // KEYS_PER_PAGE
        s = p * KEYS_PER_PAGE
        vpage = value_page_of(p, self.n_key_pages)
        self.resolve_burst()                # read-your-writes ordering
        self.backend.program_entries(
            vpage, self.values[s:s + KEYS_PER_PAGE])
        self.programs += 1

    # ------------------------------------------------------------- finish
    def finish(self) -> None:
        """End of stream: final burst and full drain."""
        self.resolve_burst()
        self.drain_inflight()

    # ------------------------------------------------------------- report
    def report(self, source: str) -> RunReport:
        stats = self.backend.stats
        return RunReport(
            source=source,
            read_values=self.out, read_hits=self.hits,
            counters=CounterReport(
                reads=self.n_reads, writes=self.n_writes,
                flushes=self.flushes,
                kernel_launches=stats.kernel_launches,
                staged_bytes=stats.staged_bytes,
                result_bytes=stats.result_bytes,
                programs=self.programs),
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
    first resolve the open burst (read-your-writes).  A scan op
    (``ops == 2``) raises ``NotImplementedError``.
    """
    if (np.asarray(workload.ops) == 2).any():
        raise NotImplementedError(
            "YCSB-E scans (range plans) are not ported yet: slice 2 of the "
            "port")
    core = ReplayCore(workload, backend, config)
    wl = workload
    for qi in range(len(wl.ops)):
        if wl.ops[qi] == 0:
            core.queue_read(qi)
            if len(core.pending) >= config.burst:
                core.resolve_burst()
        else:
            core.write(qi)
    core.finish()
    return core.report("serial")
