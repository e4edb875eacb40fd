"""Closed-loop analytic executor (the timing half of the repro).

Mirrors the paper's measurement protocol (§VI-A4, footnote 6): statistics
start after a 30 % warmup; QPS = measured queries / measured makespan.

``run`` is the *timing* simulation on SSDSim (latency/energy, no real
data), all on the host in numpy: the same arithmetic as the JAX package's
runner, so its reports are equal, field for field.  Reads are match-mode
search+gather pairs, writes are buffered page programs, and YCSB-E scans
(``ops == 2``) are match-mode multi-page READS over the key pages the range
touches — never writes.  Returns a :class:`repro_torch.frontend.RunReport`
(source ``"analytic"``).

The *functional* execution of the op stream against real programmed
pages lives in :func:`repro_torch.frontend.replay`, configured by a
:class:`repro_torch.frontend.RunConfig`.

``RunResult`` and ``FunctionalRunResult`` are aliases of ``RunReport`` —
the one result schema of every executor — whose flat attributes
(``qps``, ``n_reads``, ``sim_makespan_ns``, ...) are readable properties
over the nested sections.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.flash.params import FlashParams
from repro_torch.flash.ssd import SSDSim
from repro_torch.frontend import RunReport
from .ycsb import KEYS_PER_PAGE, Workload

WARMUP_FRACTION = 0.30
FULL_MASK = 0xFFFFFFFFFFFFFFFF

# Legacy names: both executor result schemas unified into RunReport.
RunResult = RunReport
FunctionalRunResult = RunReport


def run(workload: Workload, *, params: FlashParams, system: str,
        cache_coverage: float, clients: int = 16,
        full_page_read_ratio: float = 0.0,
        batch_deadline_ns: float | None = None,
        power_budget_ma: float | None = None, seed: int = 0) -> RunReport:
    """Execute a workload closed-loop on one simulated SSD."""
    cache_pages = int(round(cache_coverage * workload.n_index_pages))
    sim = SSDSim(params, n_index_pages=workload.n_index_pages,
                 cache_pages=cache_pages, system=system,
                 power_budget_ma=power_budget_ma, seed=seed)
    rng = np.random.default_rng(seed + 17)

    n = len(workload.ops)
    warmup = int(n * WARMUP_FRACTION)
    # Closed loop: heap of (ready_time, client, next_query_index).
    heap = [(0.0, c) for c in range(clients)]
    heapq.heapify(heap)
    next_q = 0
    warmup_end_t = None
    energy_at_warmup = 0.0
    stats_mark = None
    lat_mark = 0

    # Deadline batching (§IV-E): queries wait up to deadline for same-page
    # peers.  Approximated by counting same-page arrivals within the window
    # using a small pending map keyed by page.
    pending_same_page: dict[int, list[float]] = {}

    n_key_pages = workload.n_index_pages // 2
    n_keys = n_key_pages * KEYS_PER_PAGE

    def scan_pages(qi: int) -> list[int]:
        """Key pages a YCSB-E scan touches — same placement arithmetic as
        the functional executor's scan path, so both executors model an
        identical page footprint for one op stream."""
        if workload.keys is None or workload.scan_lens is None:
            return [int(workload.key_pages[qi])]
        lo = int(workload.keys[qi]) + 1          # stored key of id k is k+1
        hi = min(lo + int(workload.scan_lens[qi]), n_keys + 1)
        if lo >= hi:
            return []
        p0 = (lo - 1) // KEYS_PER_PAGE
        p1 = (hi - 2) // KEYS_PER_PAGE
        return list(range(p0, min(p1, n_key_pages - 1) + 1))

    while next_q < n:
        now, client = heapq.heappop(heap)
        op = workload.ops[next_q]
        kp = int(workload.key_pages[next_q])
        vp = int(workload.value_pages[next_q])

        if next_q == warmup:
            warmup_end_t = now
            energy_at_warmup = sim.energy.total_pj
            stats_mark = dataclasses.replace(sim.stats)
            lat_mark = len(sim.read_latencies)

        if op == 0:
            batch_extra = 0
            if batch_deadline_ns is not None and system == "sim":
                window = pending_same_page.setdefault(kp, [])
                window[:] = [t for t in window if t >= now - batch_deadline_ns]
                batch_extra = len(window)
                window.append(now)
                # queries joining a batch pay the residual wait
                now = now + (batch_deadline_ns if batch_extra == 0 else 0.0)
            full = (system == "sim"
                    and rng.random() < full_page_read_ratio)
            end = sim.read(kp, vp, now, force_full_page=full,
                           batch_extra=batch_extra)
        elif op == 2:
            # YCSB-E scan: a match-mode multi-page READ.  This used to fall
            # into the write branch below, counting every scan as a page
            # write (wrong QPS/latency/energy, phantom programs on any
            # scan_ratio > 0 workload).
            end = sim.scan(scan_pages(next_q), now)
        else:
            end = sim.submit_write(kp, vp, now)
        heapq.heappush(heap, (end, client))
        next_q += 1

    makespan = max(t for t, _ in heap) - (warmup_end_t or 0.0)
    lats = np.array(sim.read_latencies[lat_mark:]) if sim.read_latencies \
        else np.array([0.0])
    measured = n - warmup
    s, m = sim.stats, stats_mark
    return RunReport.from_analytic(
        qps=measured / (makespan / 1e9) if makespan > 0 else 0.0,
        read_median_ns=float(np.median(lats)),
        read_p25_ns=float(np.percentile(lats, 25)),
        read_p75_ns=float(np.percentile(lats, 75)),
        read_p99_ns=float(np.percentile(lats, 99)),
        energy_pj=sim.energy.total_pj - energy_at_warmup,
        programs=s.programs - (m.programs if m else 0),
        senses=s.senses - (m.senses if m else 0),
        internal_bytes=s.internal_bytes - (m.internal_bytes if m else 0),
        pcie_bytes=s.pcie_bytes - (m.pcie_bytes if m else 0),
        cache_hit_rate=sim.cache.stats.hit_rate,
        absorbed_writes=sim.cache.stats.absorbed_writes,
        batched_searches=s.batched_searches - (m.batched_searches if m else 0),
        makespan_ns=makespan,
        reads=s.reads - (m.reads if m else 0),
        writes=s.writes - (m.writes if m else 0),
        scans=s.scans - (m.scans if m else 0),
    )
