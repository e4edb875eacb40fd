"""Sharded multi-chip SSD backend: channels x dies chips, one launch a phase.

The scalar and batched backends drive what is in effect ONE chip's worth of
device state.  This backend owns ``channels x dies_per_channel`` chips behind
the same four-method ``MatchBackend`` contract and uses their parallelism the
way the paper's controller does (§VI-A, TCAM-SSD's channel-level framework).

Address space.  A global page address stripes across chips exactly like
``SimChipArray.route`` — ``chip = addr % n_chips``, ``local = addr //
n_chips`` (:func:`decompose` / :func:`compose`) — so stored images, and
therefore every response, are bit-identical to the scalar and batched
backends over the same array.  The single-chip backends are the 1x1 case.

Per-chip state.  Every chip has its own pending command queue; the rows of
all chips live in ONE ``PlaneStore`` arena, grouped per chip at flush time.
``flush()`` drains every chip with one launch a phase:

  * searches — each chip's unique pages and unique (query, mask) rows pad
    to a common geometry and ONE chip-axis ``sim_search`` launch (the
    counterpart of the JAX package's ``jax.vmap`` over the chip axis) reads
    each chip's rows of the arena in place through a (C, R) row index.  A
    chip's queries match only its own pages, so the cross product is about
    1/chips of the single-arena launch — per-channel match engines;
  * plans (Op.PLAN) — each chip's unique pages and unique (include,
    exclude) pass tuples dedup per chip and ONE chip-axis ``sim_plan``
    launch evaluates them over ``take2d`` copies of the rows (the plan
    kernel keeps one input convention in both backends); the OR/AND-NOT
    combine happens in-kernel (Fig 10), so the timeline charges
    ``n_passes`` match ops but one 64 B bitmap a page;
  * lookups — the lookup kernel is row-parallel (row i searches key page
    i, gathers value page i), so rows of every chip ride one row-stacked
    launch reading the arena in place; the key and value page of one
    lookup may live on different chips (the §V-A cross-die pairing);
  * gathers — the same row stacking through one ``sim_gather`` launch.

Padded chips and rows point at arena row 0; their outputs are never read.
Page and lookup rows pad in blocks of 8 (``SHARDED_PAGE_BLOCK``,
``SHARDED_LOOKUP_BLOCK``), the JAX package's sharded geometry, so the raw
launch outputs equal its own.

Ticket resolution is lazy as in the batched backend; timeline accounting
happens at flush time.  Pass ``timeline=True`` (or a ``BurstTimeline``) to
report every flush as per-chip ``ChipBurst`` records that replay on
flash/ssd.py's die, channel and PCIe timelines: ``frontend.replay`` then
returns bit-exact results plus a simulated latency and energy account.

``replicas=k`` stripes k-1 extra copies of every eagerly or deferred
programmed page over the next chips, from the top of each chip's local
space.  ``enable_device_faults`` attaches a ``DeviceFaultState``: programs
draw seeded failures and remap grown bad blocks to spares (bounded
retries), writes to a dead chip relocate to a spare on the next live chip,
and at flush every command that touches a chip dead at the fault clock
is rewritten to a live replica page and served through the same kernels
from the replica's rows (``_flush_failover``, counted in ``failovers``
and ``degraded_ops``, charged as degraded full-page reads), or fails with
a typed ``DegradedReadError``.  Only the outage set routes a command
there.  With a reliability tier attached (``enable_reliability``)
the flush runs the optimistic open burst before staging and charges
read-retries, fallback reads and ``vote_k`` senses a match on the
timeline.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bits import popcount_words
from repro_torch.core.commands import Command, Op
from repro_torch.core.ecc import OpenVerdict
from repro_torch.core.engine import SimChipArray
from repro_torch.flash.params import (BITMAP_BYTES, CHUNK_BYTES, FlashParams,
                                      OPEN_OVERHEAD_BYTES, PAGE_BYTES)
from repro_torch.flash.timeline import BurstTimeline, ChipBurst
from repro_torch.kernels.layout import tensor_to_words, words_to_tensor
from repro_torch.kernels.sim_plan.ops import sim_plan_chips
from repro_torch.kernels.sim_plan.ref import plan_pass_rows
from repro_torch.kernels.sim_search.ops import sim_search_chips
from repro_torch.reliability.errors import DegradedReadError

from .base import MatchBackend, Ticket
from .batched import (launch_gathers, launch_lookups, resolve_plan_responses,
                      resolve_search_responses)
from .planestore import PlaneStore, next_pow2, padded_rows

QUERY_BYTES = 16               # (query, mask) uint32 pairs shipped per search
# Padded row blocks of the JAX package's sharded backend (``padded_rows``),
# so launch geometries and raw outputs compare equal with it.
SHARDED_PAGE_BLOCK = 8
SHARDED_LOOKUP_BLOCK = 8


def decompose(page_addr: int, n_chips: int) -> tuple[int, int]:
    """Global page -> (chip, local page), striped across the chip array."""
    return page_addr % n_chips, page_addr // n_chips


def compose(chip: int, local: int, n_chips: int) -> int:
    """(chip, local page) -> global page; inverse of :func:`decompose`."""
    return local * n_chips + chip


class ShardedSsdBackend(MatchBackend):
    """channels x dies chips, per-chip queues, one launch a flush phase.

    ``chips`` must hold ``channels * dies_per_channel`` chips (geometry
    defaults to one channel a chip).  ``device=None`` runs on the current
    CUDA device; ``device="cpu"`` runs the plain PyTorch versions of the
    kernels.  Results are bit-identical to the scalar and batched backends
    over the same array.
    """

    # Bounded program retry budget: a seeded program-failure draw relocates
    # the page to a spare and retries at most this many times.
    MAX_PROGRAM_ATTEMPTS = 8

    def __init__(self, chips: SimChipArray, *, channels: int | None = None,
                 dies_per_channel: int | None = None,
                 timeline: BurstTimeline | bool | None = None,
                 replicas: int = 1, device=None):
        super().__init__(chips)
        n_chips = len(chips.chips)
        if channels is None:
            channels = n_chips if dies_per_channel is None else \
                n_chips // dies_per_channel
        if dies_per_channel is None:
            dies_per_channel = n_chips // channels
        if channels * dies_per_channel != n_chips:
            raise ValueError(
                f"geometry {channels}x{dies_per_channel} != {n_chips} chips")
        self.channels = channels
        self.dies_per_channel = dies_per_channel
        if timeline is True:
            timeline = BurstTimeline(FlashParams(
                channels=channels, dies_per_channel=dies_per_channel))
        if timeline is not None and timeline is not False \
                and timeline.n_chips != n_chips:
            raise ValueError(f"timeline models {timeline.n_chips} dies, "
                             f"backend has {n_chips} chips")
        self.timeline: BurstTimeline | None = timeline or None
        # One arena for every chip's rows, grouped per chip at flush time;
        # its log of dirty restages charges write-backs on the timeline.
        self.store = PlaneStore(chips, block=SHARDED_PAGE_BLOCK, device=device,
                                log_staging=True)
        self.device = self.store.device
        self._pending: list[list[tuple[str, Command, Ticket]]] = [
            [] for _ in chips.chips]
        # k-replica striping: every program fans out to k-1 copies on the
        # next chips round-robin, allocated from the TOP of each chip's
        # local address space (primary data grows from the bottom).
        if not 1 <= replicas <= n_chips:
            raise ValueError(f"replicas={replicas} needs 1..{n_chips}")
        self.replicas = replicas
        self._replica_of: dict[int, tuple[int, ...]] = {}
        self._spare_next: list[int] = [chips.pages_per_chip - 1
                                       for _ in chips.chips]
        # DeviceFaultState (repro_torch.reliability.device_faults) or None.
        self.faults = None
        # The arena of failover reads (replica rows), made at the first.
        self._failover_store: PlaneStore | None = None

    # ------------------------------------------------------------ geometry
    @classmethod
    def from_geometry(cls, *, channels: int, dies_per_channel: int = 1,
                      pages_per_chip: int = 512, device_seed: int = 0,
                      **kw) -> "ShardedSsdBackend":
        """Build the chip array from SSD geometry (FlashParams convention:
        ``channels x dies_per_channel`` chips)."""
        arr = SimChipArray(n_chips=channels * dies_per_channel,
                           pages_per_chip=pages_per_chip,
                           device_seed=device_seed)
        return cls(arr, channels=channels,
                   dies_per_channel=dies_per_channel, **kw)

    @property
    def n_chips(self) -> int:
        return len(self.chips.chips)

    def decompose(self, page_addr: int) -> tuple[int, int]:
        return decompose(page_addr, self.n_chips)

    # ------------------------------------------------------------- storage
    def program_entries(self, page_addr: int, entries, **kw):
        built = self._program_page(page_addr, entries, kw)
        if self.timeline is not None:
            for c in self._program_chips(page_addr):
                self.timeline.observe_program(c)
        return built

    def _program_chips(self, page_addr: int) -> list[int]:
        """Chips a logical program lands on: the (possibly remapped)
        primary plus every replica — replica fan-out is charged on the
        timelines like any other program."""
        return [self._mapped(page_addr) % self.n_chips] + [
            self._mapped(r) % self.n_chips
            for r in self._replica_of.get(page_addr, ())]

    # --------------------------------------------------- fault-aware placing
    def enable_device_faults(self, state) -> None:
        """Attach a DeviceFaultState: programs draw seeded failures (grown
        bad blocks remap to spares), reads consult the outage set at flush
        and fail over to replicas, and the attached timeline schedules
        stall windows onto its resource lines."""
        self.faults = state
        if self.timeline is not None:
            self.timeline.attach_faults(state)

    def _alloc_spare(self, chip: int) -> int:
        """Carve one spare page off the top of a chip's local space."""
        local = self._spare_next[chip]
        programmed = self.chips.chips[chip].pages
        while local >= 0 and local in programmed:
            local -= 1
        if local < 0:
            raise RuntimeError(
                f"chip {chip}: out of spare pages (replicas/bad-block "
                "remap exhausted the local address space)")
        self._spare_next[chip] = local - 1
        return compose(chip, local, self.n_chips)

    def _next_live_chip(self, chip: int) -> int:
        """First chip after ``chip`` (round-robin) not in the outage set."""
        for off in range(1, self.n_chips + 1):
            c = (chip + off) % self.n_chips
            if not self.faults.chip_dead(c):
                return c
        return chip                        # whole array dead: nowhere left

    def _mapped(self, addr: int) -> int:
        """Follow the bad-block remap chain to the live physical page."""
        if self.faults is None:
            return addr
        remap = self.faults.remap
        for _ in range(len(remap)):
            nxt = remap.get(addr)
            if nxt is None:
                break
            addr = nxt
        return addr

    def _replica_addrs(self, addr: int) -> tuple[int, ...]:
        """The k-1 replica pages of a primary (allocated at first program,
        striped across the next chips round-robin)."""
        if self.replicas <= 1:
            return ()
        reps = self._replica_of.get(addr)
        if reps is None:
            chip = addr % self.n_chips
            reps = tuple(self._alloc_spare((chip + r) % self.n_chips)
                         for r in range(1, self.replicas))
            self._replica_of[addr] = reps
        return reps

    def _program_page(self, page_addr: int, entries, kw):
        """Fault-aware program: primary (with bad-block remap and bounded
        seeded retry) plus every replica.  The logical address never
        changes — only the physical placement does."""
        built = self._program_physical(page_addr, entries, kw)
        for rep in self._replica_addrs(page_addr):
            self._program_physical(rep, entries, kw)
            if self.faults is not None:
                self.faults.stats.replica_programs += 1
        return built

    def _program_physical(self, addr: int, entries, kw):
        """Program one physical page, relocating off dead chips and around
        seeded program failures (grown bad blocks) with a bounded retry."""
        target = self._mapped(addr)
        if self.faults is not None:
            chip = target % self.n_chips
            if self.faults.chip_dead(chip):
                # The owning chip is offline: relocate to a spare on the
                # next live chip so writes survive the outage.
                spare = self._alloc_spare(self._next_live_chip(chip))
                self.faults.mark_bad(target, spare)
                target = spare
            for attempt in range(self.MAX_PROGRAM_ATTEMPTS):
                if not self.faults.program_fails(target, attempt):
                    break
                spare = self._alloc_spare(target % self.n_chips)
                self.faults.mark_bad(target, spare)
                target = spare
        return self.chips.program_entries(target, entries, **kw)

    # ------------------------------------------------------------ deferred
    def _submit(self, kind: str, cmd: Command) -> Ticket:
        t = Ticket(self)
        chip, _ = self.decompose(cmd.page_addr)
        self._pending[chip].append((kind, cmd, t))
        return t

    def submit_search(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.SEARCH or cmd.query is None or cmd.mask is None:
            raise ValueError(f"not a search command: {cmd}")
        return self._submit("search", cmd)

    def submit_gather(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.GATHER or cmd.chunk_bitmap is None:
            raise ValueError(f"not a gather command: {cmd}")
        return self._submit("gather", cmd)

    def submit_lookup(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.LOOKUP or cmd.value_page is None:
            raise ValueError(f"not a lookup command: {cmd}")
        return self._submit("lookup", cmd)

    def submit_plan(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.PLAN or cmd.plan_include is None:
            raise ValueError(f"not a plan command: {cmd}")
        return self._submit("plan", cmd)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._pending) + self.pending_programs

    # --------------------------------------------------------------- flush
    def flush(self) -> None:
        # Deferred write path first: one grouped chip-program pass, ONE
        # plane-store scatter for every programmed row, and one program-
        # group report to the timeline (programs queue on each die's
        # program line; restaged dirty planes charge the storage-mode
        # channel bus — the client clock does not advance).
        programs = self._execute_programs()
        if programs:
            self.store.stage_group(programs)
            if self.timeline is not None:
                staged, self.store.staged_log = self.store.staged_log, []
                self.timeline.observe_program_group(
                    [c for a in programs for c in self._program_chips(a)],
                    restage_chips=[self.decompose(a)[0] for a in staged])
            self.stats.staged_bytes = self._staged_bytes
        if not any(self._pending):
            if programs:
                self.stats.flushes += 1
            return
        self.stats.flushes += 1
        phases = {"search": [], "lookup": [], "gather": [], "plan": []}
        for queue in self._pending:
            for kind, cmd, t in queue:
                if self.faults is not None and self.faults.remap:
                    cmd = self._remap_cmd(cmd)
                phases[kind].append((cmd, t))
            queue.clear()
        bursts: dict[int, ChipBurst] = {}
        # Device-fault failover: commands whose chip is offline at the
        # fault clock are rewritten to live replica pages (or fail typed)
        # and served after the healthy phases — see _flush_failover.
        failover = None
        if self.faults is not None:
            dead = self.faults.dead_chips()
            if dead:
                failover = {}
                for kind in ("search", "lookup", "gather", "plan"):
                    phases[kind], failover[kind] = self._failover(
                        kind, phases[kind], dead, bursts)
        # Reliability open burst before staging (open-time ECC repairs
        # restage corrected rows in this flush); retries and full-page
        # fallback reads charge the owning die's timeline record.
        opens = self._open_reliability(
            {c.page_addr for items in phases.values() for c, _ in items}
            | {c.value_page for c, _ in phases["lookup"]})
        if opens and self.timeline is not None:
            for a, po in opens.items():
                b = self._burst(bursts, self.decompose(a)[0])
                b.retry_senses += po.result.retries_used
                if po.verdict is OpenVerdict.FALLBACK_ECC:
                    b.fallback_reads += 1
        rel = self.reliability
        if phases["search"]:
            self._flush_searches(phases["search"], bursts, rel, opens)
        if phases["plan"]:
            self._flush_plans(phases["plan"], bursts, rel, opens)
        if phases["lookup"]:
            self._flush_lookups(phases["lookup"], bursts, rel, opens)
        if phases["gather"]:
            self._flush_gathers(phases["gather"], bursts, rel, opens)
        if failover is not None and any(failover.values()):
            self._flush_failover(failover)
        self.stats.staged_bytes = self._staged_bytes
        staged, self.store.staged_log = self.store.staged_log, []
        if self.timeline is not None:
            for a in staged:   # dirty planes restage in storage mode
                c, _ = self.decompose(a)
                self._burst(bursts, c).bus_storage_bytes += PAGE_BYTES
            self.timeline.observe_flush(
                [bursts[c] for c in sorted(bursts)])

    def _burst(self, bursts: dict[int, ChipBurst], chip: int) -> ChipBurst:
        return bursts.setdefault(chip, ChipBurst(chip))

    @property
    def _staged_bytes(self) -> int:
        """Page bytes the arena and the failover arena shipped."""
        return self.store.staged_bytes + (
            0 if self._failover_store is None
            else self._failover_store.staged_bytes)

    @property
    def _vote_factor(self) -> int:
        """Senses a match costs under the reliability tier's voting."""
        return 1 if self.reliability is None else \
            self.reliability.vote_factor

    # ---------------------------------------------------- degraded failover
    def _remap_cmd(self, cmd: Command) -> Command:
        """Follow grown-bad-block remaps; spares hold the same entries and
        responses are derandomized (address-independent), so the remapped
        read is bit-identical to the original."""
        mapped = self._mapped(cmd.page_addr)
        vmapped = (self._mapped(cmd.value_page)
                   if cmd.value_page is not None else None)
        if mapped == cmd.page_addr and vmapped == cmd.value_page:
            return cmd
        return dataclasses.replace(cmd, page_addr=mapped,
                                   value_page=vmapped)

    def _failover(self, kind: str, items, dead: set[int], bursts):
        """Split one flush list into the commands that stay on their pages
        and the failovers: a command touching a dead chip is rewritten to
        live addresses (``_live_addr`` books the degraded full-page reads)
        and its key page latched on the chip model, the implicit open of
        the modelled controller's read; it fails with a typed
        DegradedReadError when no replica survives.  Returns the kept
        (command, ticket) pairs and the (command, ticket, verdict)
        failovers, the verdict None for a gather (which opens nothing)."""
        keep, moved = [], []
        for cmd, ticket in items:
            touched = [cmd.page_addr]
            if cmd.value_page is not None:
                touched.append(cmd.value_page)
            if not any(a % self.n_chips in dead for a in touched):
                keep.append((cmd, ticket))
                continue
            try:
                addr = self._live_addr(cmd.page_addr, dead, bursts)
                vaddr = (self._live_addr(cmd.value_page, dead, bursts)
                         if cmd.value_page is not None else None)
            except DegradedReadError as e:
                ticket._fail(e)
                continue
            self.faults.stats.degraded_ops += 1
            verdict = None if kind == "gather" else self.chips.latch(addr)
            moved.append((dataclasses.replace(cmd, page_addr=addr,
                                              value_page=vaddr),
                          ticket, verdict))
        return keep, moved

    def _live_addr(self, addr: int, dead: set[int], bursts) -> int:
        """A live physical address for ``addr``: the page itself when its
        chip is up, else the first replica on a live chip (charged as one
        degraded full-page read).  Raises DegradedReadError when neither
        survives."""
        if addr % self.n_chips not in dead:
            return self._mapped(addr)
        for rep in self._replica_of.get(addr, ()):
            rep = self._mapped(rep)
            chip = rep % self.n_chips
            if chip not in dead:
                self.faults.stats.failovers += 1
                b = self._burst(bursts, chip)
                b.degraded_reads += 1
                b.pcie_bytes += PAGE_BYTES
                return rep
        raise DegradedReadError(addr)

    def _flush_failover(self, failover) -> None:
        """Serve a flush's failovers through the kernels, one launch a
        phase, after the healthy phases.  The replica holds the same
        entries and responses are derandomized, so each result is
        bit-identical to the healthy read.  As the modelled controller's
        degraded read, a failover bypasses the reliability tier (a raw
        response carrying its latch verdict) and costs the timeline only
        the degraded reads ``_failover`` booked: the phases' own sense,
        match and bus charges go to a scratch record.  Its rows stage in
        an arena of their own, so the main arena's residency and dirty
        restages, which the timeline charges, stay those of the healthy
        reads; the bytes it ships count in ``staged_bytes``."""
        if self._failover_store is None:
            self._failover_store = PlaneStore(
                self.chips, block=SHARDED_PAGE_BLOCK, device=self.device)
        main, self.store = self.store, self._failover_store
        scratch: dict[int, ChipBurst] = {}
        try:
            for kind, phase in (("search", self._flush_searches),
                                ("plan", self._flush_plans),
                                ("lookup", self._flush_lookups),
                                ("gather", self._flush_gathers)):
                if failover[kind]:
                    phase([(c, t) for c, t, _ in failover[kind]], scratch,
                          None, None, [v for _, _, v in failover[kind]])
        finally:
            self.store = main

    # ------------------------------------------------------------- staging
    def _chip_rows(self, addrs: list[list[int]], bursts):
        """Stage every active chip's unique pages; returns the active chips
        and the (c_pad, n_pad) arena-row matrix, padded chips and rows at
        row 0.  Charges one staged sense a page to its chip (``vote_k``
        of them under the reliability tier's voting)."""
        active = [c for c in range(self.n_chips) if addrs[c]]
        n_pad = max(padded_rows(len(addrs[c]), SHARDED_PAGE_BLOCK)
                    for c in active)
        flat = [a for c in active for a in addrs[c]]
        rows = self.store.rows_for(flat)
        idx2d = np.zeros((next_pow2(len(active)), n_pad), np.int32)
        off = 0
        for i, c in enumerate(active):
            k = len(addrs[c])
            idx2d[i, :k] = rows[off:off + k]
            off += k
            self.chips.chips[c].counters.array_reads += k
            b = self._burst(bursts, c)
            b.senses += k * self._vote_factor
            b.bus_match_bytes += OPEN_OVERHEAD_BYTES * k
        return active, idx2d

    # ------------------------------------------------------------- searches
    def _flush_searches(self, searches, bursts, rel, opens,
                        verdicts=None) -> None:
        # Per chip: unique pages -> arena rows; unique (query, mask) ->
        # operand rows; every command lands at one (chip, qi, pi) cell.
        # ``rel`` and ``opens`` finalize the responses (reliability tier);
        # ``verdicts``, one a command, are a failover burst's open verdicts.
        n = self.n_chips
        addrs: list[list[int]] = [[] for _ in range(n)]
        page_rows: list[dict[int, int]] = [{} for _ in range(n)]
        query_rows: list[dict[tuple, int]] = [{} for _ in range(n)]
        q_pairs: list[list] = [[] for _ in range(n)]
        m_pairs: list[list] = [[] for _ in range(n)]
        placements = []                        # (chip, qi, pi)
        for cmd, _ in searches:
            c, _local = self.decompose(cmd.page_addr)
            if cmd.page_addr not in page_rows[c]:
                page_rows[c][cmd.page_addr] = len(addrs[c])
                addrs[c].append(cmd.page_addr)
            key = (cmd.query, cmd.mask)
            if key not in query_rows[c]:
                query_rows[c][key] = len(q_pairs[c])
                q_pairs[c].append(cmd.query)
                m_pairs[c].append(cmd.mask)
            placements.append((c, query_rows[c][key],
                               page_rows[c][cmd.page_addr]))

        active, idx2d = self._chip_rows(addrs, bursts)
        slot_of = {c: i for i, c in enumerate(active)}
        q_pad = max(next_pow2(len(q_pairs[c])) for c in active)
        q = np.zeros((idx2d.shape[0], q_pad, 2), dtype=np.uint32)
        m = np.zeros_like(q)
        for i, c in enumerate(active):
            q[i, :len(q_pairs[c])] = np.asarray(q_pairs[c], np.uint32)
            m[i, :len(m_pairs[c])] = np.asarray(m_pairs[c], np.uint32)

        # Every chip's rows are read in place: one index upload, one launch.
        rows = self.store.upload_rows2d(idx2d)
        lo, hi, ids, seeds = self.store.arena()
        out = sim_search_chips(lo, hi, words_to_tensor(q, self.device),
                               words_to_tensor(m, self.device), ids, seeds,
                               randomized=True, rows=rows)  # (C, Q, N, 16)

        self.stats.kernel_launches += 1
        self.stats.staged_pages += sum(len(addrs[c]) for c in active)
        self.stats.staged_queries += sum(len(q_pairs[c]) for c in active)
        self.stats.searches += len(searches)
        if len(searches) > 1:
            self.stats.batched_searches += len(searches)
        for cmd, _ in searches:
            c, _local = self.decompose(cmd.page_addr)
            b = self._burst(bursts, c)
            b.matches += self._vote_factor
            b.bus_match_bytes += BITMAP_BYTES
            b.pcie_bytes += BITMAP_BYTES + QUERY_BYTES

        stacked = [(slot_of[c], qi, pi) for c, qi, pi in placements]

        def tail(out=out, searches=searches, stacked=stacked, rel=rel,
                 opens=opens, verdicts=verdicts):
            self.stats.result_bytes += resolve_search_responses(
                self.chips, searches, stacked, tensor_to_words(out), rel,
                opens, verdicts)
        self._defer_all(searches, tail)

    # --------------------------------------------------------------- plans
    def _flush_plans(self, plans, bursts, rel, opens, verdicts=None) -> None:
        """Fused range plans, stacked across chips like searches: per chip,
        unique pages -> rows and unique (include, exclude) pass tuples ->
        plan groups; ONE chip-axis ``sim_plan`` launch."""
        n = self.n_chips
        addrs: list[list[int]] = [[] for _ in range(n)]
        page_rows: list[dict[int, int]] = [{} for _ in range(n)]
        group_rows: list[dict[tuple, int]] = [{} for _ in range(n)]
        groups: list[list[tuple]] = [[] for _ in range(n)]
        placements = []                        # (chip, gi, pi)
        for cmd, _ in plans:
            c, _local = self.decompose(cmd.page_addr)
            if cmd.page_addr not in page_rows[c]:
                page_rows[c][cmd.page_addr] = len(addrs[c])
                addrs[c].append(cmd.page_addr)
            key = (cmd.plan_include, cmd.plan_exclude)
            if key not in group_rows[c]:
                group_rows[c][key] = len(groups[c])
                groups[c].append(key)
            placements.append((c, group_rows[c][key],
                               page_rows[c][cmd.page_addr]))

        active, idx2d = self._chip_rows(addrs, bursts)
        slot_of = {c: i for i, c in enumerate(active)}
        g_pad = max(next_pow2(len(groups[c])) for c in active)
        p_pad = next_pow2(max(max((len(i) + len(e) for i, e in groups[c]),
                                  default=1) for c in active))
        q = np.zeros((idx2d.shape[0], g_pad, p_pad, 2), dtype=np.uint32)
        m = np.zeros_like(q)
        f = np.zeros((idx2d.shape[0], g_pad, p_pad), dtype=np.uint32)
        for i, c in enumerate(active):
            for gi, (inc, exc) in enumerate(groups[c]):
                q[i, gi], m[i, gi], f[i, gi] = plan_pass_rows(inc, exc,
                                                              p_pad)

        lo, hi, ids, seeds = self.store.take2d(idx2d)
        out = sim_plan_chips(lo, hi, words_to_tensor(q, self.device),
                             words_to_tensor(m, self.device),
                             words_to_tensor(f, self.device), ids, seeds,
                             randomized=True)          # (C, G, N, 16)

        self.stats.kernel_launches += 1
        self.stats.staged_pages += sum(len(addrs[c]) for c in active)
        self.stats.staged_queries += sum(len(i) + len(e)
                                         for c in active
                                         for i, e in groups[c])
        self.stats.plans += len(plans)
        for cmd, _ in plans:
            c, _local = self.decompose(cmd.page_addr)
            b = self._burst(bursts, c)
            b.matches += cmd.n_passes * self._vote_factor  # every pass
            b.bus_match_bytes += BITMAP_BYTES  # ...but ONE bitmap crosses
            b.pcie_bytes += BITMAP_BYTES + QUERY_BYTES * cmd.n_passes

        stacked = [(slot_of[c], gi, pi) for c, gi, pi in placements]

        def tail(out=out, plans=plans, stacked=stacked, rel=rel,
                 opens=opens, verdicts=verdicts):
            self.stats.result_bytes += resolve_plan_responses(
                self.chips, plans, stacked, tensor_to_words(out), rel,
                opens, verdicts)
        self._defer_all(plans, tail)

    # -------------------------------------------------------------- lookups
    def _flush_lookups(self, lookups, bursts, rel, opens,
                       verdicts=None) -> None:
        """Row-stacked fused burst across every chip (the batched backend's
        launch); each side of a lookup charges its own chip's burst."""
        launch_lookups(self, lookups, SHARDED_LOOKUP_BLOCK, rel, opens,
                       verdicts)
        vf = self._vote_factor
        # Key pages re-sense vote_k times for majority voting; value pages
        # sense once (the chunk read is verified by parity, not by vote).
        for addrs, senses in (({cmd.page_addr for cmd, _ in lookups}, vf),
                              ({cmd.value_page for cmd, _ in lookups}, 1)):
            for a in addrs:                    # one open per unique page
                c, _ = self.decompose(a)
                b = self._burst(bursts, c)
                b.senses += senses
                b.bus_match_bytes += OPEN_OVERHEAD_BYTES
        for cmd, _ in lookups:
            kc, _ = self.decompose(cmd.page_addr)
            vc, _ = self.decompose(cmd.value_page)
            kb = self._burst(bursts, kc)
            kb.matches += vf
            kb.bus_match_bytes += BITMAP_BYTES
            kb.pcie_bytes += BITMAP_BYTES + QUERY_BYTES
            vb = self._burst(bursts, vc)
            vb.bus_match_bytes += CHUNK_BYTES
            vb.pcie_bytes += CHUNK_BYTES

    # -------------------------------------------------------------- gathers
    def _flush_gathers(self, gathers, bursts, rel, opens,
                       verdicts=None) -> None:
        """Row-stacked gather across every chip (the batched backend's
        launch), charged to each page's chip.  A gather opens nothing, so
        a failover burst's ``verdicts`` are all None."""
        launch_gathers(self, gathers, SHARDED_PAGE_BLOCK, rel, opens)
        for cmd, _ in gathers:
            c, _local = self.decompose(cmd.page_addr)
            k = int(popcount_words(
                np.asarray(cmd.chunk_bitmap, np.uint32)).sum())
            b = self._burst(bursts, c)
            b.senses += 1
            b.bus_match_bytes += CHUNK_BYTES * k
            b.pcie_bytes += CHUNK_BYTES * k
