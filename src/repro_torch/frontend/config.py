"""RunConfig: the one validated knob surface of the workload frontend.

The same frozen dataclass as the JAX package's, field for field, so a
configuration reads the same in both packages:

  * **execution mode** — ``mode="serial"`` is the synchronous replay (one
    client, a barrier per burst); ``mode="event"`` drives the same
    functional core through the event-loop simulator
    (:mod:`repro_torch.frontend.eventloop`) with N concurrent client
    streams, a bounded NCQ and a scheduler policy;
  * **burst shaping** — ``burst`` (max reads coalesced per backend
    flush), ``fused`` (one fused lookup launch vs split search+gather);
  * **write path** — ``write_buffer``/``write_high_water`` (the §VI DRAM
    coalescing buffer with deferred grouped programs): ``True`` builds a
    ``WriteBuffer(high_water=write_high_water)``, or pass one;
  * **event frontend** — ``concurrency`` client streams, ``arrival``
    process (``zero``/``poisson``/``trace``), ``scheduler`` policy
    (``fifo``/``read_priority``/``fair_share``), ``ncq_depth`` bound and
    the per-stream ``seed``;
  * **reliability tier** — ``reliability=ReliabilityState(...)``;
  * **fault tolerance** — ``faults`` (a seeded
    :class:`repro_torch.reliability.FaultSchedule` of die/channel stalls,
    chip outages and program failures), per-command ``deadline_ns`` with
    ``max_retries`` bounded seeded-backoff re-admissions
    (``backoff_base_ns``), hedged reads after a ``hedge_quantile`` burst
    latency, and ``shed_capacity`` overload backpressure (arrivals beyond
    NCQ + shed_capacity complete with a typed error instead of queueing
    unboundedly).

Every combination is validated at construction, so a config that
constructs is a config that runs.  Presets: ``eager()``, ``buffered()``,
``reliable()``, ``open_loop()``, ``event_serial()`` (event mode at one
stream, zero inter-arrival and FIFO, which replays bit-identically to
``mode="serial"``) and ``chaos()`` (event mode with a fault schedule plus
deadline/retry armed).
"""
from __future__ import annotations

import dataclasses
import typing

from repro_torch.buffer.writebuffer import WriteBuffer
from repro_torch.reliability.device_faults import FaultSchedule

MODES = ("serial", "event")
ARRIVALS = ("zero", "poisson", "trace")
SCHEDULERS = ("fifo", "read_priority", "fair_share")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Validated, immutable configuration of one workload replay."""

    # --- execution mode
    mode: str = "serial"
    # --- backend burst shaping
    burst: int = 64
    fused: bool = False
    # --- write path (§VI DRAM write buffer)
    write_buffer: bool | WriteBuffer = False
    write_high_water: int = 16
    # --- reliability tier (repro_torch.reliability.ReliabilityState | None)
    reliability: typing.Any = None
    # --- event frontend: arrivals
    concurrency: int = 1                 # concurrent client streams
    arrival: str = "zero"                # zero | poisson | trace
    arrival_rate_qps: float | None = None    # poisson: offered load, ops/s
    arrival_times_ns: tuple | None = None    # trace: explicit times (N,)
    # --- event frontend: queueing
    scheduler: str = "fifo"              # fifo | read_priority | fair_share
    ncq_depth: int = 64                  # bounded native command queue
    seed: int = 0                        # arrival-process seed root
    record_trace: bool = False           # keep the full event trace
    # --- fault tolerance
    faults: FaultSchedule | None = None
    deadline_ns: float | None = None     # per-read deadline (event mode)
    max_retries: int = 2                 # re-admissions before typed error
    backoff_base_ns: float = 50_000.0    # exp backoff base (seeded jitter)
    hedge_quantile: float | None = None  # hedge reads past this burst-lat q
    shed_capacity: int | None = None     # overflow slots before shedding

    # ------------------------------------------------------------ checks
    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival {self.arrival!r} not in {ARRIVALS}")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"scheduler {self.scheduler!r} not in {SCHEDULERS}")
        for field in ("burst", "write_high_water", "concurrency",
                      "ncq_depth"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be an int >= 1, got {v!r}")
        if self.arrival == "poisson":
            if self.mode != "event":
                raise ValueError("poisson arrivals need mode='event'")
            if not self.arrival_rate_qps or self.arrival_rate_qps <= 0:
                raise ValueError("poisson arrivals need "
                                 f"arrival_rate_qps > 0, got "
                                 f"{self.arrival_rate_qps!r}")
        elif self.arrival_rate_qps is not None:
            raise ValueError(f"arrival_rate_qps only applies to "
                             f"arrival='poisson', not {self.arrival!r}")
        if self.arrival == "trace":
            if self.mode != "event":
                raise ValueError("trace arrivals need mode='event'")
            if self.arrival_times_ns is None:
                raise ValueError("trace arrivals need arrival_times_ns")
            object.__setattr__(self, "arrival_times_ns",
                               tuple(float(t) for t in
                                     self.arrival_times_ns))
            if any(t < 0 for t in self.arrival_times_ns):
                raise ValueError("arrival_times_ns must be >= 0")
        elif self.arrival_times_ns is not None:
            raise ValueError("arrival_times_ns only applies to "
                             f"arrival='trace', not {self.arrival!r}")
        if self.mode == "serial":
            # Event-only knobs left at non-defaults would silently not
            # apply to the serial replay — refuse instead.  (``faults`` IS
            # allowed in serial mode: outages/remaps act on the backend
            # flush path; only the queueing-time machinery needs the event
            # loop.)
            for field, default in (("concurrency", 1), ("arrival", "zero"),
                                   ("scheduler", "fifo"),
                                   ("deadline_ns", None),
                                   ("hedge_quantile", None),
                                   ("shed_capacity", None)):
                if getattr(self, field) != default:
                    raise ValueError(
                        f"{field}={getattr(self, field)!r} needs "
                        "mode='event' (the serial replay has no queue)")
        if self.deadline_ns is not None and self.deadline_ns <= 0:
            raise ValueError(f"deadline_ns must be > 0, got "
                             f"{self.deadline_ns!r}")
        if not isinstance(self.max_retries, int) or self.max_retries < 0:
            raise ValueError(f"max_retries must be an int >= 0, got "
                             f"{self.max_retries!r}")
        if self.backoff_base_ns <= 0:
            raise ValueError(f"backoff_base_ns must be > 0, got "
                             f"{self.backoff_base_ns!r}")
        if self.hedge_quantile is not None and not (
                0.0 < self.hedge_quantile < 1.0):
            raise ValueError(f"hedge_quantile must be in (0, 1), got "
                             f"{self.hedge_quantile!r}")
        if self.shed_capacity is not None and (
                not isinstance(self.shed_capacity, int)
                or self.shed_capacity < 0):
            raise ValueError(f"shed_capacity must be an int >= 0, got "
                             f"{self.shed_capacity!r}")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultSchedule):
            raise ValueError(f"faults must be a FaultSchedule, got "
                             f"{self.faults!r}")
        if not isinstance(self.write_buffer, (bool, WriteBuffer)):
            raise ValueError("write_buffer must be a bool or a WriteBuffer, "
                             f"got {self.write_buffer!r}")

    # ------------------------------------------------------------ presets
    @classmethod
    def eager(cls, **kw) -> "RunConfig":
        """Serial replay, eager per-write programs — the bit-exactness
        reference every other configuration is held to."""
        return cls(**kw)

    @classmethod
    def buffered(cls, *, write_high_water: int = 16, **kw) -> "RunConfig":
        """Serial replay through the §VI DRAM write buffer: hot-page
        coalescing, grouped deferred programs, overlay reads."""
        return cls(write_buffer=True, write_high_water=write_high_water,
                   **kw)

    @classmethod
    def reliable(cls, reliability, **kw) -> "RunConfig":
        """Serial replay with the §IV-C reliability tier attached."""
        if reliability is None:
            raise ValueError("reliable() needs a ReliabilityState")
        return cls(reliability=reliability, **kw)

    @classmethod
    def open_loop(cls, arrival_rate_qps: float, *, concurrency: int = 16,
                  scheduler: str = "read_priority", **kw) -> "RunConfig":
        """Open-loop event-driven run: Poisson arrivals at the offered
        QPS across ``concurrency`` client streams."""
        return cls(mode="event", arrival="poisson",
                   arrival_rate_qps=arrival_rate_qps,
                   concurrency=concurrency, scheduler=scheduler, **kw)

    @classmethod
    def event_serial(cls, **kw) -> "RunConfig":
        """The degenerate event config — one stream, zero inter-arrival,
        FIFO — whose replay must be bit-identical to ``mode='serial'``."""
        return cls(mode="event", arrival="zero", concurrency=1,
                   scheduler="fifo", **kw)

    @classmethod
    def chaos(cls, faults, *, deadline_ns: float = 2_000_000.0,
              max_retries: int = 4, scheduler: str = "read_priority",
              **kw) -> "RunConfig":
        """Event-driven run under a device fault schedule with the
        robustness tier armed: per-read deadlines, bounded seeded-backoff
        retries, read-priority scheduling.  Hedging and shedding stay off
        unless asked for — they change the latency story."""
        if faults is None:
            raise ValueError("chaos() needs a FaultSchedule")
        return cls(mode="event", faults=faults, deadline_ns=deadline_ns,
                   max_retries=max_retries, scheduler=scheduler, **kw)

    # ------------------------------------------------------------- helper
    def with_(self, **kw) -> "RunConfig":
        """A copy with the given fields replaced (re-validated)."""
        return dataclasses.replace(self, **kw)
