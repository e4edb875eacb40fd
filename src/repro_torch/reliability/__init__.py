"""Reliability tier: deterministic fault injection and ECC-aware matching.

``FaultModel`` (faults.py) corrupts stored pages and match-mode senses under
one seed; ``ReliabilityState`` (policy.py) threads the §IV-C2/C3 optimistic
open / voting / selective-verification pipeline through every backend's
flush, surfacing outer-code failures as typed per-ticket
``UncorrectableReadError``s.  ``FaultSchedule``/``DeviceFaultState``
(device_faults.py) model *device*-level failures — die/channel stalls,
permanent chip outages, grown bad blocks — behind replica failover and
typed ``DegradedReadError``s.  The typed errors live in errors.py.
"""
from .device_faults import (ChipOutage, CommandTimeoutError,
                            DeviceFaultState, FaultSchedule, FaultStats,
                            OverloadShedError, StallWindow)
from .errors import DegradedReadError, UncorrectableReadError, require_clean
from .faults import (DAY_NS, FaultModel, majority_flip_prob,
                     sense_false_negative_bound, sense_false_positive_bound)
from .policy import (PageOpen, ReliabilityPolicy, ReliabilityState,
                     ReliabilityStats, match_bitmap, plan_bitmap)

__all__ = [
    "DAY_NS", "FaultModel", "majority_flip_prob",
    "sense_false_negative_bound", "sense_false_positive_bound",
    "PageOpen", "ReliabilityPolicy", "ReliabilityState", "ReliabilityStats",
    "UncorrectableReadError", "match_bitmap", "plan_bitmap", "require_clean",
    "ChipOutage", "CommandTimeoutError", "DegradedReadError",
    "DeviceFaultState", "FaultSchedule", "FaultStats", "OverloadShedError",
    "StallWindow",
]
