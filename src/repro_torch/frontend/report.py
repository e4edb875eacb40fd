"""RunReport: the one result schema of every workload executor.

The same nested sections as the JAX package's report — ``latency`` /
``energy`` / ``counters`` / ``reliability`` / ``faults`` — so results read
the same in both packages.  Three executors fill it:

  * the analytic simulator (``workload.runner.run`` →
    :meth:`RunReport.from_analytic`): latency percentiles, energy and the
    SSD resource counters;
  * the serial functional replay (``repro_torch.frontend.replay``): the
    backend counters and the bit-exact per-op outputs (read values and
    hits, scan counts), with the timeline's latencies and energy on a
    timeline-coupled backend;
  * the event-driven frontend (``mode="event"``), which also fills the
    per-request latency distribution and the NCQ/admission counters.

A replay with the reliability tier fills ``reliability`` (typed per-op
errors, refreshes, the ``ReliabilityStats``); one with the device-fault
tier (``RunConfig(faults=...)`` or any robustness knob) fills ``faults``,
whose counter names are the JAX package's schema.  The flat attribute
names of the executors' results (``report.read_median_ns``,
``report.n_reads``, ...) are read-only properties over the sections.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _percentile(lats, q: float) -> float:
    if lats is None or len(lats) == 0:
        return 0.0
    return float(np.percentile(np.asarray(lats), q))


@dataclasses.dataclass
class LatencyReport:
    """Simulated-time distribution of one run (ns unless suffixed)."""
    read_p50_ns: float = 0.0
    read_p25_ns: float = 0.0
    read_p75_ns: float = 0.0
    read_p99_ns: float = 0.0
    qps: float = 0.0              # measured throughput, ops/s
    makespan_ns: float = 0.0      # simulated wall time of the measured ops
    # Distributions (None where the executor does not model them):
    read_latencies_ns: np.ndarray | None = None   # per read op
    burst_latencies_ns: np.ndarray | None = None  # per backend flush
    write_latencies_ns: np.ndarray | None = None  # per page program

    @classmethod
    def from_read_latencies(cls, lats, *, makespan_ns: float = 0.0,
                            n_ops: int = 0, **kw) -> "LatencyReport":
        qps = n_ops / (makespan_ns / 1e9) if makespan_ns > 0 else 0.0
        return cls(read_p50_ns=_percentile(lats, 50),
                   read_p25_ns=_percentile(lats, 25),
                   read_p75_ns=_percentile(lats, 75),
                   read_p99_ns=_percentile(lats, 99),
                   qps=qps, makespan_ns=makespan_ns,
                   read_latencies_ns=(np.asarray(lats, dtype=np.float64)
                                      if lats is not None and len(lats)
                                      else None), **kw)


@dataclasses.dataclass
class EnergyReport:
    """NAND-side energy account (paper Fig 13 discipline)."""
    total_pj: float = 0.0


@dataclasses.dataclass
class CounterReport:
    """Exact op/resource counters; every field is machine-independent."""
    # op stream
    reads: int = 0
    writes: int = 0
    scans: int = 0
    # functional backend traffic
    flushes: int = 0             # backend flushes issued by the executor
    kernel_launches: int = 0     # device launches
    staged_bytes: int = 0        # host->device page bytes
    result_bytes: int = 0        # exact device->host result payload bytes
    programs: int = 0            # page programs issued
    write_flushes: int = 0       # write-buffer group flushes
    buffer_read_hits: int = 0    # reads served from the DRAM overlay
    # analytic-simulator resources
    senses: int = 0
    internal_bytes: int = 0
    pcie_bytes: int = 0
    batched_searches: int = 0
    cache_hit_rate: float = 0.0
    absorbed_writes: int = 0
    # event frontend
    events: int = 0              # events processed by the loop
    dispatches: int = 0          # device dispatches (bursts + barrier ops)
    admitted: int = 0            # requests admitted straight into the NCQ
    admission_waits: int = 0     # arrivals held at the NCQ high-water mark
    ncq_peak: int = 0            # max queued+inflight ever observed


@dataclasses.dataclass
class ReliabilityReport:
    """Per-op outcomes of the §IV-C tier (empty when not attached)."""
    read_errors: np.ndarray | None = None   # (N,) bool typed-error flags
    n_read_errors: int = 0
    refreshes: int = 0                      # stale pages rewritten at drain
    stats: object | None = None             # ReliabilityStats snapshot


@dataclasses.dataclass
class FaultReport:
    """Device-fault tier outcomes (all zero when the tier is off)."""
    timeouts: int = 0            # read bursts past deadline_ns
    retries: int = 0             # NCQ re-admissions after timeout
    backoff_waits: int = 0       # exponential-backoff sleeps taken
    hedges_won: int = 0          # hedged duplicate reads that won
    failovers: int = 0           # replica reads after primary-chip death
    remapped_blocks: int = 0     # bad blocks remapped to spare pages
    degraded_ops: int = 0        # host-side scalar-path degraded ops
    shed_requests: int = 0       # arrivals refused by backpressure
    replica_programs: int = 0    # replica mirror programs issued
    program_failures: int = 0    # injected program faults observed
    op_errors: np.ndarray | None = None   # (N,) bool typed-error flags
    n_op_errors: int = 0


@dataclasses.dataclass
class RunReport:
    """One run, one shape — analytic or serial replay."""
    source: str = "serial"       # "analytic" | "serial"
    latency: LatencyReport = dataclasses.field(default_factory=LatencyReport)
    energy: EnergyReport = dataclasses.field(default_factory=EnergyReport)
    counters: CounterReport = dataclasses.field(
        default_factory=CounterReport)
    reliability: ReliabilityReport = dataclasses.field(
        default_factory=ReliabilityReport)
    faults: FaultReport = dataclasses.field(default_factory=FaultReport)
    # Functional replays only: bit-exact per-op outputs.
    read_values: np.ndarray | None = None   # (N,) uint64, 0 where no hit
    read_hits: np.ndarray | None = None     # (N,) bool
    scan_counts: np.ndarray | None = None   # (N,) int64, 0 off-scan ops
    trace: tuple = ()

    # ----------------------------------------------------------- builders
    @classmethod
    def from_analytic(cls, *, qps, read_median_ns, read_p25_ns, read_p75_ns,
                      read_p99_ns, energy_pj, programs, senses,
                      internal_bytes, pcie_bytes, cache_hit_rate,
                      absorbed_writes, batched_searches, makespan_ns,
                      writes=0, scans=0, reads=0) -> "RunReport":
        """Package the closed-form simulator's measurement window."""
        return cls(
            source="analytic",
            latency=LatencyReport(
                read_p50_ns=read_median_ns, read_p25_ns=read_p25_ns,
                read_p75_ns=read_p75_ns, read_p99_ns=read_p99_ns,
                qps=qps, makespan_ns=makespan_ns),
            energy=EnergyReport(total_pj=energy_pj),
            counters=CounterReport(
                reads=reads, writes=writes, scans=scans, programs=programs,
                senses=senses, internal_bytes=internal_bytes,
                pcie_bytes=pcie_bytes, cache_hit_rate=cache_hit_rate,
                absorbed_writes=absorbed_writes,
                batched_searches=batched_searches))

    # ------------------------------------------------- flat aliases
    # Functional replay names.
    @property
    def n_reads(self) -> int:
        return self.counters.reads

    @property
    def n_writes(self) -> int:
        return self.counters.writes

    @property
    def n_scans(self) -> int:
        return self.counters.scans

    @property
    def flushes(self) -> int:
        return self.counters.flushes

    @property
    def kernel_launches(self) -> int:
        return self.counters.kernel_launches

    @property
    def staged_bytes(self) -> int:
        return self.counters.staged_bytes

    @property
    def result_bytes(self) -> int:
        return self.counters.result_bytes

    @property
    def programs(self) -> int:
        return self.counters.programs

    @property
    def write_flushes(self) -> int:
        return self.counters.write_flushes

    @property
    def buffer_read_hits(self) -> int:
        return self.counters.buffer_read_hits

    @property
    def burst_latencies_ns(self):
        return self.latency.burst_latencies_ns

    @property
    def write_latencies_ns(self):
        return self.latency.write_latencies_ns

    @property
    def sim_makespan_ns(self) -> float:
        return self.latency.makespan_ns

    @property
    def sim_energy_pj(self) -> float:
        return self.energy.total_pj

    @property
    def read_errors(self):
        return self.reliability.read_errors

    @property
    def n_read_errors(self) -> int:
        return self.reliability.n_read_errors

    @property
    def refreshes(self) -> int:
        return self.reliability.refreshes

    @property
    def reliability_stats(self):
        return self.reliability.stats

    # Analytic simulator names.
    @property
    def qps(self) -> float:
        return self.latency.qps

    @property
    def read_median_ns(self) -> float:
        return self.latency.read_p50_ns

    @property
    def read_p25_ns(self) -> float:
        return self.latency.read_p25_ns

    @property
    def read_p75_ns(self) -> float:
        return self.latency.read_p75_ns

    @property
    def read_p99_ns(self) -> float:
        return self.latency.read_p99_ns

    @property
    def energy_pj(self) -> float:
        return self.energy.total_pj

    @property
    def senses(self) -> int:
        return self.counters.senses

    @property
    def internal_bytes(self) -> int:
        return self.counters.internal_bytes

    @property
    def pcie_bytes(self) -> int:
        return self.counters.pcie_bytes

    @property
    def cache_hit_rate(self) -> float:
        return self.counters.cache_hit_rate

    @property
    def absorbed_writes(self) -> int:
        return self.counters.absorbed_writes

    @property
    def batched_searches(self) -> int:
        return self.counters.batched_searches

    @property
    def makespan_ns(self) -> float:
        return self.latency.makespan_ns

    @property
    def writes(self) -> int:
        return self.counters.writes

    @property
    def scans(self) -> int:
        return self.counters.scans
