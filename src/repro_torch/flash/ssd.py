"""Timeline-based SSD simulator for the paper's system evaluation (§VI–VII).

Resources are modelled as monotone free-time timelines (die array ops,
per-channel internal buses, the PCIe link, and an optional peak-current pool
for bus transfers per §II-B).  A closed loop of clients issues queries; every
query walks its phase chain, each phase starting at
max(ready, resource_free).  This captures queueing delay, die/channel
parallelism, sense/transfer pipelining and the dirty-eviction stalls that
drive the paper's results, at ~1 us of Python per simulated query — fast
enough for the full Fig 12–18 grids.

Two systems share the machinery (§VI-A3):
  * ``baseline``: CPU-centric — full 4 KiB page reads through the OS page
    cache (clean inserts compete with the write buffer), host-side search;
  * ``sim``: SiM — search+gather commands in match mode, reads bypass the
    cache entirely, the whole cache acts as a write buffer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cache.pagecache import PageCache
from .params import (BITMAP_BYTES, CHUNK_BYTES, FlashParams,
                     OPEN_OVERHEAD_BYTES, PAGE_BYTES)


@dataclasses.dataclass
class EnergyAccount:
    """NAND-chip-side energy only (paper's Fig 13 accounting)."""
    sense_pj: float = 0.0
    program_pj: float = 0.0
    bus_pj: float = 0.0
    match_pj: float = 0.0

    @property
    def total_pj(self) -> float:
        return self.sense_pj + self.program_pj + self.bus_pj + self.match_pj


@dataclasses.dataclass
class SimStats:
    reads: int = 0
    writes: int = 0
    scans: int = 0
    senses: int = 0
    programs: int = 0
    matches: int = 0
    full_page_reads: int = 0
    internal_bytes: int = 0
    pcie_bytes: int = 0
    batched_searches: int = 0
    open_page_hits: int = 0


class SSDSim:
    # Linux vm.dirty_ratio default: the kernel page cache throttles writers
    # once ~20 % of it is dirty.  SiM's application-managed write buffer has
    # no such cap (reads never enter it) — see PageCache docstring.
    BASELINE_DIRTY_FRACTION = 0.20

    def __init__(self, params: FlashParams, *, n_index_pages: int,
                 cache_pages: int, system: str,
                 power_budget_ma: float | None = None, seed: int = 0):
        assert system in ("baseline", "sim")
        self.p = params
        self.system = system
        self.n_index_pages = n_index_pages
        self.cache = PageCache(
            cache_pages,
            max_dirty_fraction=(self.BASELINE_DIRTY_FRACTION
                                if system == "baseline" else 1.0))
        self.energy = EnergyAccount()
        self.stats = SimStats()
        self.read_latencies: list[float] = []
        self.write_latencies: list[float] = []
        self.scan_latencies: list[float] = []
        self._rng = np.random.default_rng(seed)

        n_dies = params.n_dies
        # Two timelines per die: senses (reads) run with read priority /
        # program-suspend (standard in modern controllers), programs queue
        # separately and only contend with each other.
        self.die_sense_free = np.zeros(n_dies)
        self.die_prog_free = np.zeros(n_dies)
        self.chan_free = np.zeros(params.channels)
        self.pcie_free = 0.0
        # Async write-back backpressure: a client stalls only when the
        # victim die's program backlog exceeds this window.
        self.prog_backlog_ns = 4 * params.t_program_ns
        # Match-mode page-buffer state (§IV-B): the page latched per die.  A
        # search/gather that targets the open page skips the array sense and
        # the open-verification transfer — the latch-pipelining reuse the
        # batch-matching of §IV-E also exploits.  Storage-mode ops clobber
        # the latches (programs and full-page reads invalidate).
        self.open_page = np.full(n_dies, -1, dtype=np.int64)
        # §II-B peak-current pool for bus transfers (None = unconstrained)
        if power_budget_ma is not None:
            slots_storage = max(1, int(power_budget_ma
                                       / params.bus_peak_ma_storage))
            slots_match = max(1, int(power_budget_ma
                                     / params.bus_peak_ma_match))
            self._pool_storage = np.zeros(slots_storage)
            self._pool_match = np.zeros(slots_match)
        else:
            self._pool_storage = self._pool_match = None

    # ----------------------------------------------------------- resources
    def _die_of(self, page: int) -> int:
        return page % self.p.n_dies

    def _chan_of(self, die: int) -> int:
        return die % self.p.channels

    def _sense(self, page: int, ready: float) -> float:
        die = self._die_of(page)
        start = max(ready, self.die_sense_free[die])
        end = start + self.p.t_read_ns
        self.die_sense_free[die] = end
        self.stats.senses += 1
        self.energy.sense_pj += self.p.e_sense_pj()
        return end

    def _program(self, page: int, ready: float) -> float:
        die = self._die_of(page)
        start = max(ready, self.die_prog_free[die])
        end = start + self.p.t_program_ns
        self.die_prog_free[die] = end
        self.open_page[die] = -1          # program clobbers the page buffer
        self.stats.programs += 1
        self.energy.program_pj += self.p.e_program_pj()
        return end

    def _bus(self, page: int, ready: float, n_bytes: int,
             match_mode: bool) -> float:
        chan = self._chan_of(self._die_of(page))
        start = max(ready, self.chan_free[chan])
        if self._pool_storage is not None:
            pool = self._pool_match if match_mode else self._pool_storage
            slot = int(np.argmin(pool))
            start = max(start, pool[slot])
        dur = self.p.bus_time_ns(n_bytes, match_mode)
        end = start + dur
        self.chan_free[chan] = end
        if self._pool_storage is not None:
            pool[slot] = end
        self.stats.internal_bytes += n_bytes
        self.energy.bus_pj += self.p.e_bus_pj(n_bytes, match_mode)
        return end

    def _pcie(self, ready: float, n_bytes: int) -> float:
        start = max(ready, self.pcie_free)
        end = start + self.p.pcie_time_ns(n_bytes)
        self.pcie_free = end
        self.stats.pcie_bytes += n_bytes
        return end

    def _match(self, ready: float, n_queries: int = 1) -> float:
        self.stats.matches += n_queries
        self.energy.match_pj += self.p.e_match_pj() * n_queries
        return ready + self.p.t_match_ns * n_queries

    # ------------------------------------------------------ fault scheduling
    # Device-fault stalls (the device-fault tier, slice 7 of the port) are
    # scheduled directly onto the resource timelines: a blocked die/channel
    # simply has its free-time pushed past the stall window, so every later
    # phase queues behind it through the ordinary max(ready, free)
    # discipline — no special-case latency paths.
    def block_die(self, die: int, until: float) -> None:
        """Hold both of a die's timelines (sense + program) to ``until``."""
        self.die_sense_free[die] = max(self.die_sense_free[die], until)
        self.die_prog_free[die] = max(self.die_prog_free[die], until)

    def block_channel(self, chan: int, until: float) -> None:
        """Hold a channel's internal bus timeline to ``until``."""
        self.chan_free[chan] = max(self.chan_free[chan], until)

    # -------------------------------------------------------- page fetches
    def _fetch_full_page(self, page: int, now: float) -> float:
        """Storage-mode full page to host: sense -> bus -> PCIe -> kernel."""
        t = self._sense(page, now)
        self.open_page[self._die_of(page)] = -1   # storage-mode read clobbers
        t = self._bus(page, t, PAGE_BYTES, match_mode=False)
        t = self._pcie(t, PAGE_BYTES)
        self.stats.full_page_reads += 1
        return t + self.p.host_io_overhead_ns

    def _writeback(self, victim: int, now: float) -> float:
        """Full write I/O for a dirty victim: PCIe + internal bus + program.

        The kernel-path overhead applies to the baseline only (SiM's write
        buffer is flushed by the application through the same MMIO command
        path as its reads).
        """
        t = now + (self.p.host_io_overhead_ns if self.system == "baseline"
                   else 0.0)
        t = self._pcie(t, PAGE_BYTES)
        t = self._bus(victim, t, PAGE_BYTES, match_mode=False)
        return self._program(victim, t)

    def _evict_sync(self, evicted: list[tuple[int, bool]],
                    now: float) -> float:
        """Baseline semantics: the evicting thread performs the write-back
        inline (direct reclaim / vm.dirty_ratio writer throttling) and waits
        for it — the §VII-A/C read-behind-write-back stall."""
        done = now
        for victim, was_dirty in evicted:
            if was_dirty:
                done = max(done, self._writeback(victim, now))
        return done

    def _evict_async(self, evicted: list[tuple[int, bool]],
                     now: float) -> float:
        """SiM semantics: the application-managed write buffer flushes in the
        background; the client stalls only when the victim die's program
        backlog exceeds the queue window (the §VII-D sporadic-peak tail)."""
        done = now
        for victim, was_dirty in evicted:
            if not was_dirty:
                continue
            end = self._writeback(victim, now)
            stall_until = end - self.prog_backlog_ns
            if stall_until > now:
                done = max(done, stall_until)
        return done

    # ------------------------------------------------------------- queries
    def read_baseline(self, key_page: int, value_page: int,
                      now: float) -> float:
        hit_k = self.cache.lookup(key_page)
        hit_v = self.cache.lookup(value_page)
        if hit_k and hit_v:
            return now + self.p.dram_hit_ns + self.p.cpu_search_ns
        done = now
        for page, hit in ((key_page, hit_k), (value_page, hit_v)):
            if hit:
                continue
            t = self._fetch_full_page(page, now)      # fetches run parallel
            t = self._evict_sync(self.cache.insert(page, dirty=False), t)
            done = max(done, t)
        return done + self.p.cpu_search_ns

    def _open_for_match(self, page: int, now: float) -> float:
        """page_open in match mode: skip the sense + verification transfer
        when the page is already latched in the die's buffer (§IV-B)."""
        die = self._die_of(page)
        if self.open_page[die] == page:
            self.stats.open_page_hits += 1
            return now
        t = self._sense(page, now)
        t = self._bus(page, t, OPEN_OVERHEAD_BYTES, match_mode=True)
        self.open_page[die] = page
        return t

    def read_sim(self, key_page: int, value_page: int, now: float,
                 batch_extra: int = 0) -> float:
        """search(key page) + pipelined gather(value page) (§V-A).

        ``batch_extra`` > 0 models additional queued searches sharing this
        page sense (deadline scheduler, §IV-E).
        """
        # key page: open (sense + verification transfer) + match + bitmap out
        t = self._open_for_match(key_page, now)
        t = self._match(t, 1 + batch_extra)
        if batch_extra:
            self.stats.batched_searches += batch_extra
        t = self._bus(key_page, t, BITMAP_BYTES * (1 + batch_extra),
                      match_mode=True)
        t_bitmap = self._pcie(t, BITMAP_BYTES)
        # value page: opened speculatively in parallel with the key search,
        # gather transfer once both the open and the bitmap are ready.
        t_open_v = self._open_for_match(value_page, now)
        t = self._bus(value_page, max(t_open_v, t_bitmap), CHUNK_BYTES,
                      match_mode=True)
        t = self._pcie(t, CHUNK_BYTES)
        return t + self.p.mmio_ns

    def write(self, key_page: int, value_page: int, now: float) -> float:
        """Index update: buffer both pages dirty (write-back on eviction)."""
        if self.cache.capacity == 0:
            t1 = self._writeback(key_page, now)
            t2 = self._writeback(value_page, now)
            return max(t1, t2)
        evict = (self._evict_sync if self.system == "baseline"
                 else self._evict_async)
        done = now + self.p.dram_hit_ns
        for page in (key_page, value_page):
            done = max(done, evict(self.cache.insert(page, dirty=True), now))
        return done

    def read(self, key_page: int, value_page: int, now: float,
             force_full_page: bool = False, batch_extra: int = 0) -> float:
        self.stats.reads += 1
        if self.system == "baseline":
            end = self.read_baseline(key_page, value_page, now)
        elif force_full_page:
            # SiM system doing a legitimate full-page read (§VII-F, e.g. LSM
            # compaction or an analytic scan).  These are storage-mode reads
            # on the *conventional* I/O path — they stream through the
            # kernel page cache and therefore compete with the write buffer,
            # which is exactly why Fig 18's effect is strongest in
            # write-dominant workloads.
            end = now
            for page in (key_page, value_page):
                t = self._fetch_full_page(page, now)
                t = self._evict_sync(self.cache.insert(page, dirty=False), t)
                end = max(end, t)
            end += self.p.cpu_search_ns
        else:
            end = self.read_sim(key_page, value_page, now,
                                batch_extra=batch_extra)
        self.read_latencies.append(end - now)
        return end

    def submit_write(self, key_page: int, value_page: int,
                     now: float) -> float:
        self.stats.writes += 1
        end = self.write(key_page, value_page, now)
        self.write_latencies.append(end - now)
        return end

    # --------------------------------------------------------------- scans
    def scan(self, key_pages: list[int], now: float) -> float:
        """YCSB-E range scan over the key pages the range touches (§V-C).

        ``sim`` system: a match-mode multi-page read — per page, one
        ``_open_for_match`` (skipped when the page is already latched), one
        match op (the fused Op.PLAN evaluates every decomposition pass
        in-latch, so only the combined 64 B bitmap crosses the bus and the
        PCIe link per page).  Scans are *reads*: they never dirty the cache
        and never program — the timing executor used to funnel them into
        ``submit_write``, corrupting QPS/latency/energy and ``programs``
        for any scan-bearing workload.

        ``baseline`` system: conventional full-page reads of each touched
        page through the OS page cache + a host-side scan of the page.
        """
        self.stats.scans += 1
        end = now
        if self.system == "baseline":
            for page in key_pages:
                if self.cache.lookup(page):
                    t = now + self.p.dram_hit_ns
                else:
                    t = self._fetch_full_page(page, now)
                    t = self._evict_sync(
                        self.cache.insert(page, dirty=False), t)
                end = max(end, t)
            end += self.p.cpu_search_ns
        else:
            for page in key_pages:
                t = self._open_for_match(page, now)
                t = self._match(t)
                t = self._bus(page, t, BITMAP_BYTES, match_mode=True)
                t = self._pcie(t, BITMAP_BYTES)
                end = max(end, t)
            end += self.p.mmio_ns
        self.scan_latencies.append(end - now)
        return end
