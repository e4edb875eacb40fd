"""RunReport: the result schema of the workload replay.

The same nested sections as the JAX package's report — ``latency`` /
``energy`` / ``counters`` / ``reliability`` / ``faults`` — so results read
the same in both packages.  The serial replay of this slice fills the
counters and the bit-exact per-op outputs; the other sections stay at
their defaults until the paths that fill them (the timeline-coupled
sharded backend, the reliability and device-fault tiers, the event
frontend) are ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
    """One run, one shape."""
    source: str = "serial"
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

    # ------------------------------------------------- flat aliases
    @property
    def n_reads(self) -> int:
        return self.counters.reads

    @property
    def n_writes(self) -> int:
        return self.counters.writes

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
