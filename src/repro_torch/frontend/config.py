"""RunConfig: the one validated knob surface of the workload frontend.

The same frozen dataclass as the JAX package's, field for field, so a
configuration reads the same in both packages.  The port runs the serial
replay only:

  * **execution mode** — ``mode="serial"``, the synchronous replay (one
    client, a barrier per burst);
  * **burst shaping** — ``burst`` (max reads coalesced per backend
    flush), ``fused`` (one fused lookup launch vs split search+gather);
  * **write path** — ``write_buffer``/``write_high_water`` (the §VI DRAM
    coalescing buffer with deferred grouped programs): ``True`` builds a
    ``WriteBuffer(high_water=write_high_water)``, or pass one.

The knobs of paths not ported yet — ``mode="event"``, the ``reliability``
tier, device ``faults``, deadlines, hedging and shedding — keep their
fields, and setting any of them raises ``NotImplementedError`` at
construction, so a config that constructs is a config that runs.
"""
from __future__ import annotations

import dataclasses
import typing

from repro_torch.buffer.writebuffer import WriteBuffer

MODES = ("serial", "event")
ARRIVALS = ("zero", "poisson", "trace")
SCHEDULERS = ("fifo", "read_priority", "fair_share")

# Knob -> (value that leaves it off, the slice of the port that runs it).
_NOT_PORTED = {
    "mode": ("serial", "the event-driven frontend (slice 8 of the port)"),
    "reliability": (None, "the reliability tier (slice 8 of the port)"),
    "faults": (None, "the device-fault tier (slice 8 of the port)"),
    "deadline_ns": (None, "deadlines of the event frontend (slice 8)"),
    "hedge_quantile": (None, "hedged reads of the event frontend (slice 8)"),
    "shed_capacity": (None, "load shedding of the event frontend (slice 8)"),
}


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
    # --- reliability tier
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
    faults: typing.Any = None
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
        for field, (off, where) in _NOT_PORTED.items():
            if getattr(self, field) != off:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r}: {where} is not "
                    "ported yet")
        # Event-only knobs left at non-defaults would silently not apply
        # to the serial replay — refuse instead.
        for field, default in (("concurrency", 1), ("arrival", "zero"),
                               ("scheduler", "fifo"),
                               ("arrival_rate_qps", None),
                               ("arrival_times_ns", None)):
            if getattr(self, field) != default:
                raise ValueError(
                    f"{field}={getattr(self, field)!r} needs mode='event' "
                    "(the serial replay has no queue)")
        if not isinstance(self.max_retries, int) or self.max_retries < 0:
            raise ValueError(f"max_retries must be an int >= 0, got "
                             f"{self.max_retries!r}")
        if self.backoff_base_ns <= 0:
            raise ValueError(f"backoff_base_ns must be > 0, got "
                             f"{self.backoff_base_ns!r}")
        if not isinstance(self.write_buffer, (bool, WriteBuffer)):
            raise ValueError("write_buffer must be a bool or a WriteBuffer, "
                             f"got {self.write_buffer!r}")

    # ------------------------------------------------------------ presets
    @classmethod
    def eager(cls, **kw) -> "RunConfig":
        """Serial replay, eager per-write programs — the bit-exactness
        reference every other configuration is held to."""
        return cls(**kw)

    def with_(self, **kw) -> "RunConfig":
        """A copy with the given fields replaced (re-validated)."""
        return dataclasses.replace(self, **kw)
