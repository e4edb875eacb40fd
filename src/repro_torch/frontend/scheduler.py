"""Scheduler policies: which queued NCQ requests form the next burst.

The event loop asks its scheduler two questions, both answered as an
index into the live NCQ (a list of :class:`repro_torch.frontend.eventloop.
Request`, arrival order) or None:

  * ``pick_read(ncq)``  — the next read to pull into the burst being
    composed (called repeatedly until the burst is full or it returns
    None);
  * ``pick(ncq)``       — the next request to execute when no read is
    selectable (a write or scan barrier op).

Policies differ in selection order and in how their read bursts interact
with the die *program* timelines (``wait_program_lines``):

  ============== ============================== =========================
  policy         read selection                 program contention
  ============== ============================== =========================
  fifo           strict arrival order; a read   read bursts queue BEHIND
                 burst ends at the first        outstanding die programs
                 non-read request               (no suspend)
  read_priority  reads jump the queue (any      reads bypass program
                 position); writes/scans run    lines — program-suspend /
                 only when no read is queued    read-priority dies
  fair_share     read_priority, but reads are   same as read_priority
                 taken round-robin across
                 client streams (per-tenant
                 fair share)
  ============== ============================== =========================

FIFO is the NCQ-as-shipped reference (and the serial-parity policy at
concurrency 1); read_priority is the SiM story — §VI's write buffer turns
programs into background work precisely so reads need not wait on them —
and the JAX package's latency_sweep gate holds its p99 advantage over FIFO
under a write-heavy load.
"""
from __future__ import annotations

from .config import RunConfig

READ, WRITE, SCAN = 0, 1, 2


class FifoScheduler:
    """Strict arrival order; reads wait behind die-program backlog."""

    wait_program_lines = True

    def __init__(self, config: RunConfig):
        pass

    def pick(self, ncq) -> int | None:
        return 0 if ncq else None

    def pick_read(self, ncq) -> int | None:
        return 0 if ncq and ncq[0].kind == READ else None


class ReadPriorityScheduler:
    """Reads jump the queue and program-suspend past die backlogs."""

    wait_program_lines = False

    def __init__(self, config: RunConfig):
        pass

    def pick(self, ncq) -> int | None:
        return 0 if ncq else None

    def pick_read(self, ncq) -> int | None:
        for i, r in enumerate(ncq):
            if r.kind == READ:
                return i
        return None


class FairShareScheduler(ReadPriorityScheduler):
    """Read-priority with per-tenant round-robin read selection."""

    def __init__(self, config: RunConfig):
        self.concurrency = config.concurrency
        self._last = config.concurrency - 1   # so stream 0 serves first

    def pick_read(self, ncq) -> int | None:
        for off in range(1, self.concurrency + 1):
            s = (self._last + off) % self.concurrency
            for i, r in enumerate(ncq):
                if r.kind == READ and r.stream == s:
                    self._last = s
                    return i
        return None


_POLICIES = {
    "fifo": FifoScheduler,
    "read_priority": ReadPriorityScheduler,
    "fair_share": FairShareScheduler,
}


def make_scheduler(config: RunConfig):
    return _POLICIES[config.scheduler](config)
