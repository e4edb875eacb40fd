"""MatchBackend: the batched search/gather contract, defined once.

Index structures and workload runners never talk to a chip directly — they
enqueue commands against a backend and flush, which is what turns a YCSB
read burst into one device operation instead of a per-page command storm
(paper §IV-E batch matching).

Three interchangeable implementations ship in the port:

  * ``ScalarBackend`` (scalar.py) — the numpy ``SimChip``/``SimChipArray``
    functional model, executing queued commands one page at a time on the
    host.  This is the bit-exact reference, with the full latch/ECC
    machinery; ``as_backend`` wraps a bare chip array in it.
  * ``BatchedKernelBackend`` (batched.py) — stored pages stay device
    resident in a ``PlaneStore`` arena (planestore.py), queued searches run
    as one ``sim_search`` launch, queued gathers as one ``sim_gather``
    launch, queued range plans as one ``sim_plan`` launch and queued
    lookups as one fused lookup launch, with the per-page randomization
    stream regenerated in-kernel.
  * ``ShardedSsdBackend`` (sharded.py) — the same contract over a whole
    SSD of ``channels x dies_per_channel`` chips with per-chip queues: a
    flush's searches and plans are each one chip-axis launch, lookups and
    gathers one row-stacked launch across chips, optionally coupled to the
    flash timelines (flash/timeline.py) for per-burst latency and energy.

The write path is deferred: ``submit_program`` queues a full-page entry
image; repeated programs of one page within a burst coalesce last-wins and
only one chip program executes.  At ``flush()`` the queued programs run
first, so commands flushed alongside them see the new images.

Result delivery is *lazy*: ``flush()`` dispatches the launches and attaches
a ``LazyResultBatch`` to each ticket; the device->host copy and host tail
run at the first ``result()`` call of a burst, so the card works on burst k
while the host stages burst k+1.

Protocol invariants (enforced by ``repro_torch.analysis``; rule IDs in
brackets):

  I1 [SIM001, SIM009]  Ticket discipline.  Every ``submit_*`` return value
      is kept, and a ``.result()`` reached with more than one command
      pending is dominated by a ``flush()``.  The eager ``search``/
      ``gather``/``lookup``/``plan`` wrappers are the documented immediate
      mode: one straight-line submit whose ``Ticket.result()`` flushes.
  I2 [SIM002]  Observer completeness.  Every mutation of a stored page
      image notifies the write observers, and every arena-plane mutation
      (``PlaneStore._lo``/``_hi``/...) updates the staging bookkeeping.
  I3 [SIM003]  No host sync in the hot path.  ``flush``/``_flush_*`` and
      the kernel ``ops.py`` wrappers never force a device->host transfer
      (``.item()``, ``.cpu()``, ``tensor_to_words``, a synchronize) on a
      launch output; the host tail lives in the deferred closures.
  I4 [SIM004]  Counter integrity.  ``BackendStats`` fields move only
      inside the accounting helpers: flush phases, submit/resolve paths
      and deferred tails.
  I5 [SIM007]  Unit suffixes.  ``_ns``, ``_pj``, ``_bytes`` and ``_prob``
      name a quantity's dimension; values flow only between names of one
      dimension.
  I6 [SIM008]  Seed provenance.  Every RNG construction (``default_rng``,
      ``SeedSequence``, ``torch.Generator().manual_seed(x)``, ...) and every
      torch draw's ``generator=`` traces to a literal or a seed-named value.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np

from repro_torch.core.commands import (Command, GatherResponse,
                                       LookupResponse, ReadFullResponse,
                                       SearchResponse)
from repro_torch.core.engine import SimChipArray


@dataclasses.dataclass
class BackendStats:
    searches: int = 0          # search commands resolved
    gathers: int = 0           # gather commands resolved
    lookups: int = 0           # fused lookup commands resolved
    plans: int = 0             # fused multi-pass plan commands resolved
    flushes: int = 0           # non-empty flush() calls
    kernel_launches: int = 0   # device launches
    staged_pages: int = 0      # page rows referenced across launches
    staged_queries: int = 0    # query rows staged across launches
    staged_bytes: int = 0      # page-plane bytes shipped host->device; with
                               # the device-resident store this stops growing
                               # once the working set is warm
    batched_searches: int = 0  # searches that shared a launch with >= 1 peer
    programs: int = 0          # deferred Op.PROGRAM commands executed
    programs_coalesced: int = 0  # queued programs absorbed by a later
                               # program of the same page before the flush
    result_bytes: int = 0      # exact device->host result payload: 64 B per
                               # search or plan bitmap (per unique launch
                               # cell), 64 B per gathered chunk, 64 B bitmap
                               # + 64 B value chunk (on hit) per lookup


class LazyResultBatch:
    """Deferred host tail of one flushed launch.

    ``flush()`` dispatches the launch and keeps its outputs as device
    tensors, attaching one of these to every ticket of the burst; the first
    ``result()`` call runs the host tail (device->host copy, de-randomize /
    verify, ticket resolution) for the whole burst at once.  ``run()`` is
    idempotent — later tickets find themselves already resolved.
    """

    __slots__ = ("_fn", "_exc")

    def __init__(self, fn):
        self._fn = fn
        self._exc = None

    def run(self) -> None:
        if self._exc is not None:
            # A previous drain attempt failed: re-raise the root cause on
            # every later ticket of the burst.
            raise self._exc
        fn, self._fn = self._fn, None
        if fn is not None:
            try:
                fn()
            except BaseException as e:
                self._exc = e
                raise


class Ticket:
    """Deferred response handle returned by ``submit_*``.

    ``result()`` on an unresolved ticket flushes the owning backend first,
    so eager callers never deadlock; batch-aware callers submit many
    tickets and flush once.  A flush attaches a :class:`LazyResultBatch`
    instead of a value (``done`` reads True either way).
    """

    __slots__ = ("_backend", "_value", "_batch", "_exc")

    def __init__(self, backend: "MatchBackend"):
        self._backend = backend
        self._value = None
        self._batch = None
        self._exc = None

    def _resolve(self, value) -> None:
        self._value = value
        self._batch = None

    def _fail(self, exc: BaseException) -> None:
        """Resolve the ticket to a typed per-command error: ``result()``
        raises it instead of returning a wrong response."""
        self._exc = exc
        self._batch = None

    def _defer(self, batch: LazyResultBatch) -> None:
        self._batch = batch

    @property
    def done(self) -> bool:
        return (self._value is not None or self._batch is not None
                or self._exc is not None)

    def result(self):
        if self._value is None and self._exc is None and self._batch is None:
            self._backend.flush()
        if self._value is None and self._exc is None \
                and self._batch is not None:
            self._batch.run()
        if self._exc is not None:
            raise self._exc
        if self._value is None:
            raise RuntimeError("flush() left a submitted ticket unresolved")
        return self._value


class MatchBackend(abc.ABC):
    """Batched search/gather execution over a SimChipArray's stored pages."""

    def __init__(self, chips: SimChipArray):
        self.chips = chips
        self.stats = BackendStats()
        # Reliability tier (repro_torch.reliability.ReliabilityState) or
        # None.  When attached, flush() runs an optimistic open burst over
        # every touched page and routes responses through the vote/verify/
        # fallback finalize paths; uncorrectable pages fail their tickets
        # with a typed error instead of resolving a wrong bitmap.
        self.reliability = None
        # Deferred Op.PROGRAM queue: page addr -> [entries, kwargs, tickets].
        # A dict so repeated programs of one page coalesce last-wins before
        # anything touches the chip (insertion order = program order).
        self._program_queue: dict[int, list] = {}

    def enable_reliability(self, state) -> None:
        """Attach a reliability tier to this backend's flush path.  Usually
        called through ``ReliabilityState.install`` /
        ``replay(..., RunConfig.reliable(...))``."""
        self.reliability = state

    def _open_reliability(self, page_addrs) -> dict:
        """Flush-time ECC-aware open burst over the flush's unique pages;
        {} when no reliability tier is attached.  Runs before the kernel
        backends stage plane rows, so open-time repairs ship corrected
        rows in the same flush."""
        if self.reliability is None:
            return {}
        return self.reliability.open_burst(self.chips, page_addrs)

    # ------------------------------------------------------------- storage
    def program_entries(self, page_addr: int, entries, **kw):
        return self._program_page(page_addr, entries, kw)

    def _program_page(self, page_addr: int, entries, kw):
        """Program one page on the chip model, eager or deferred.  The
        sharded backend overrides it to fan a write out to its replicas
        and remap grown bad blocks; the page keeps its logical address."""
        return self.chips.program_entries(page_addr, entries, **kw)

    def submit_program(self, page_addr: int, entries, **kw) -> Ticket:
        """Queue a deferred page program (Op.PROGRAM).

        The entry image is copied at submit time.  Programs of the same
        page coalesce last-wins: one chip program executes at flush and
        every ticket of the page resolves to the final image's
        ``BuiltPage``.
        """
        t = Ticket(self)
        arr = np.array(entries, dtype=np.uint64, copy=True)
        entry = self._program_queue.get(int(page_addr))
        if entry is None:
            self._program_queue[int(page_addr)] = [arr, kw, [t]]
        else:
            entry[0], entry[1] = arr, kw
            entry[2].append(t)
            self.stats.programs_coalesced += 1
        return t

    @property
    def pending_programs(self) -> int:
        """Queued (post-coalescing) deferred programs."""
        return len(self._program_queue)

    def _execute_programs(self) -> list[int]:
        """Run the queued programs against the chip model, in submit order;
        resolve their tickets and return the programmed page addresses."""
        if not self._program_queue:
            return []
        queue, self._program_queue = self._program_queue, {}
        addrs: list[int] = []
        for page_addr, (entries, kw, tickets) in queue.items():
            built = self._program_page(page_addr, entries, kw)
            self.stats.programs += 1
            for t in tickets:
                t._resolve(built)
            addrs.append(page_addr)
        return addrs

    def read_full(self, page_addr: int) -> ReadFullResponse:
        return self.chips.read_full(page_addr)

    # ----------------------------------------------------------- immediate
    def search(self, cmd: Command) -> SearchResponse:
        return self.submit_search(cmd).result()

    def gather(self, cmd: Command) -> GatherResponse:
        return self.submit_gather(cmd).result()

    def lookup(self, cmd: Command) -> LookupResponse:
        return self.submit_lookup(cmd).result()

    def _defer_all(self, tickets, tail) -> None:
        """Attach one lazy host tail to a burst's (cmd, ticket) pairs: the
        launch outputs stay on the device until the first result()."""
        batch = LazyResultBatch(tail)
        for _, t in tickets:
            t._defer(batch)

    # ------------------------------------------------------------ deferred
    @abc.abstractmethod
    def submit_search(self, cmd: Command) -> Ticket:
        """Queue a search; the ticket resolves at the next flush()."""

    @abc.abstractmethod
    def submit_gather(self, cmd: Command) -> Ticket:
        """Queue a gather; the ticket resolves at the next flush()."""

    @abc.abstractmethod
    def submit_lookup(self, cmd: Command) -> Ticket:
        """Queue a fused point lookup (Op.LOOKUP): search the key page,
        select the first matching user slot, gather that slot's chunk from
        the paired value page.  Resolves to a LookupResponse at flush()."""

    @abc.abstractmethod
    def submit_plan(self, cmd: Command) -> Ticket:
        """Queue a fused multi-pass range plan (Op.PLAN)."""

    @abc.abstractmethod
    def flush(self) -> None:
        """Execute every queued command and resolve its ticket."""

    @property
    @abc.abstractmethod
    def pending(self) -> int:
        """Number of queued, unresolved commands."""


def as_backend(chips_or_backend) -> MatchBackend:
    """Adapt a raw SimChipArray to the reference backend (API compat)."""
    if isinstance(chips_or_backend, MatchBackend):
        return chips_or_backend
    from .scalar import ScalarBackend
    return ScalarBackend(chips_or_backend)


def make_backend(name: str, chips: SimChipArray, **kw) -> MatchBackend:
    """Factory: ``scalar`` (the host reference), ``batched`` (single-arena
    CUDA fast path) or ``sharded`` (channels x dies chips).  For the
    kernel backends ``device=None`` runs on the current CUDA device; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels."""
    from .batched import BatchedKernelBackend
    from .scalar import ScalarBackend
    from .sharded import ShardedSsdBackend
    backends = {"scalar": ScalarBackend, "batched": BatchedKernelBackend,
                "sharded": ShardedSsdBackend}
    if name not in backends:
        raise ValueError(f"unknown backend {name!r}; pick from "
                         f"{sorted(backends)}")
    return backends[name](chips, **kw)
