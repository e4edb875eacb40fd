"""Deadline-based batch command scheduler (paper §IV-E, evaluated §VII-E).

Search commands wait in a queue until their deadline expires; at expiry every
queued command that targets the same page is released as one batch, so a
single NAND array sense (the 16 us that dominates a match) is amortized over
the whole batch.  The paper's (negative) finding — batching only pays off at
unrealistic skew — is reproduced by the JAX package's
benchmarks/fig17_batch.py.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Iterator

from .commands import Command


@dataclasses.dataclass
class BatchStats:
    submitted: int = 0
    batches: int = 0
    batched_commands: int = 0      # commands that shared a page sense
    max_batch: int = 0

    @property
    def mean_batch(self) -> float:
        return self.batched_commands / self.batches if self.batches else 0.0


class DeadlineScheduler:
    """Holds commands until deadline expiry, then batches by page address."""

    def __init__(self, deadline_ns: int):
        self.deadline_ns = int(deadline_ns)
        self._heap: list[tuple[int, int, Command]] = []
        self._by_page: dict[int, list[Command]] = defaultdict(list)
        self._seq = 0
        self.stats = BatchStats()

    def submit(self, cmd: Command, now_ns: int) -> None:
        cmd.submit_ns = now_ns
        cmd.deadline_ns = now_ns + self.deadline_ns
        heapq.heappush(self._heap, (cmd.deadline_ns, self._seq, cmd))
        self._by_page[cmd.page_addr].append(cmd)
        self._seq += 1
        self.stats.submitted += 1

    def next_expiry(self) -> int | None:
        while self._heap:
            deadline, _, cmd = self._heap[0]
            if cmd in self._by_page.get(cmd.page_addr, ()):
                return deadline
            heapq.heappop(self._heap)       # already drained with a batch
        return None

    def pop_expired(self, now_ns: int) -> Iterator[list[Command]]:
        """Yield batches whose head deadline has expired."""
        while self._heap:
            deadline, _, head = self._heap[0]
            if deadline > now_ns:
                return
            heapq.heappop(self._heap)
            pending = self._by_page.get(head.page_addr)
            if not pending or head not in pending:
                continue                    # superseded by an earlier batch
            batch = list(pending)
            self._by_page.pop(head.page_addr)
            self.stats.batches += 1
            self.stats.batched_commands += len(batch)
            self.stats.max_batch = max(self.stats.max_batch, len(batch))
            yield batch

    def drain(self) -> Iterator[list[Command]]:
        """Flush everything (end of run)."""
        for page, batch in list(self._by_page.items()):
            self._by_page.pop(page)
            self.stats.batches += 1
            self.stats.batched_commands += len(batch)
            self.stats.max_batch = max(self.stats.max_batch, len(batch))
            yield batch

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_page.values())
