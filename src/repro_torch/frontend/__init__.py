"""Workload frontend of the port: RunConfig in, RunReport out, serial or
event-driven.

  * :class:`RunConfig`   — the validated, frozen knob surface (presets:
    ``eager()``, ``buffered()``, ``open_loop()``, ``event_serial()``);
  * :func:`replay`       — execute a workload's op stream against a
    MatchBackend, serially or through the event-loop simulator;
  * :class:`RunReport`   — the result schema.
"""
from .config import ARRIVALS, MODES, SCHEDULERS, RunConfig
from .eventloop import EventLoop, Request
from .replay import ReplayCore, replay
from .report import (CounterReport, EnergyReport, FaultReport, LatencyReport,
                     ReliabilityReport, RunReport)
from .scheduler import (FairShareScheduler, FifoScheduler,
                        ReadPriorityScheduler, make_scheduler)

__all__ = [
    "ARRIVALS", "MODES", "SCHEDULERS", "RunConfig", "EventLoop", "Request",
    "ReplayCore", "replay",
    "CounterReport", "EnergyReport", "FaultReport", "LatencyReport",
    "ReliabilityReport", "RunReport",
    "FairShareScheduler", "FifoScheduler", "ReadPriorityScheduler",
    "make_scheduler",
]
