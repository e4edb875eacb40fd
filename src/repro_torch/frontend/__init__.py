"""Workload frontend of the port: RunConfig in, RunReport out.

  * :class:`RunConfig`   — the validated, frozen knob surface;
  * :func:`replay`       — execute a workload's op stream against a
    MatchBackend (the serial driver);
  * :class:`RunReport`   — the result schema.
"""
from .config import ARRIVALS, MODES, SCHEDULERS, RunConfig
from .replay import ReplayCore, replay
from .report import (CounterReport, EnergyReport, FaultReport, LatencyReport,
                     ReliabilityReport, RunReport)

__all__ = [
    "ARRIVALS", "MODES", "SCHEDULERS", "RunConfig", "ReplayCore", "replay",
    "CounterReport", "EnergyReport", "FaultReport", "LatencyReport",
    "ReliabilityReport", "RunReport",
]
