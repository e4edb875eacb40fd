"""Batched MatchBackend: queued commands execute as one CUDA launch over
device-resident page planes.

Stored pages live in a ``PlaneStore`` arena (planestore.py): persistent
device tensors holding each staged page's lo/hi word planes plus its
chip-local flash address and device seed.  Pages are populated lazily the
first time a flush references them and invalidated incrementally through
the engine's write observers, so a steady-state flush ships **zero page
bytes** host->device — only the query operands move, the analogue of the
chip keeping operands in-array while only queries and 64 B bitmaps cross
the bus (paper §III-B).

At flush time the deferred queues stage into dense device operands:

  * every *unique* page touched by a queued search becomes one arena-row
    reference; the kernel regenerates the §IV-C1 randomization stream
    from the row's address/seed operands (stored images are staged as-is);
  * every *unique* (query, mask) pair becomes one row of the (Q, 2) query
    operands — Q queries match against N pages in a single ``sim_search``
    launch, the §IV-E cross-page multi-query batch;
  * queued gathers reference per-command arena rows and compact through one
    ``sim_gather`` launch; de-randomization and inner-code verification of
    the selected chunks happen host-side, batched over the whole burst;
  * queued lookups (Op.LOOKUP) run the fused lookup kernel: key-page
    search, first-matching-user-slot selection, and the paired value page's
    same-slot chunk gather all happen in ONE launch;
  * queued plans (Op.PLAN) run the fused ``sim_plan`` kernel: every
    include/exclude pass of a §V-C range decomposition matches on the card
    and the OR/AND-NOT combine (paper Fig 10) happens before anything
    leaves it — ONE 64 B bitmap per (plan, page) instead of one per pass.
    Unique (include, exclude) tuples dedup to plan groups the way unique
    (query, mask) pairs dedup to query rows.

Ticket resolution is *lazy*: each flush phase dispatches its launch and
attaches a ``LazyResultBatch`` holding the device outputs; the host copy,
de-randomization and CRC verification run at the first ``result()`` call
of the burst, and ``BackendStats.result_bytes`` counts exactly what crossed
device->host.

Query rows, plan pass rows and plan groups are padded to the next power of
two and page/gather/lookup rows to a power-of-two multiple of the block
size (``padded_rows``): the launch geometry of the JAX package, kept so raw
launch outputs compare equal.  Padded page rows repeat arena row 0, pad
queries (q = 0, m = 0) match everything, pad plan rows (PASS_PAD) enter
neither accumulator and pad lookups (m = all ones) miss; the counters count
real rows only.

The reliability tier is a later slice of the port and raises
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ecc
from repro_torch.core.bits import (CHUNK_BYTES, CHUNKS_PER_PAGE,
                                   SLOTS_PER_CHUNK, popcount_words,
                                   slot_words_to_bytes, unpack_bitmap)
from repro_torch.core.commands import (Command, GatherResponse,
                                       LookupResponse, Op, SearchResponse)
from repro_torch.core.ecc import OpenVerdict
from repro_torch.core.engine import SimChipArray
from repro_torch.core.randomize import chunk_stream_words_batch
from repro_torch.kernels.layout import (planes_to_chunk_words,
                                        tensor_to_words, words_to_tensor)
from repro_torch.kernels.sim_fused.ops import sim_fused_lookup
from repro_torch.kernels.sim_fused.ref import NO_SLOT
from repro_torch.kernels.sim_gather.ops import sim_gather
from repro_torch.kernels.sim_plan.ops import sim_plan
from repro_torch.kernels.sim_plan.ref import plan_pass_rows
from repro_torch.kernels.sim_search.ops import sim_search

from .base import MatchBackend, Ticket
from .planestore import PlaneStore, next_pow2, padded_rows

# Padded launch geometry (``padded_rows``): page and gather rows round up
# to a power-of-two multiple of PAGE_BLOCK, lookup rows of LOOKUP_BLOCK —
# the JAX package's defaults, so raw launch outputs compare equal.
PAGE_BLOCK = 32
LOOKUP_BLOCK = 8

# ---------------------------------------------------------------------------
# Host-tail resolvers: given the launch outputs as numpy uint32 arrays,
# de-randomize / verify on the controller side, bump the owning chips'
# functional counters and resolve the tickets.  Each returns the exact
# device->host result payload in bytes (the ``BackendStats.result_bytes``
# contract); with lazy tickets they run at the first ``result()`` call of a
# burst, not at flush.
# ---------------------------------------------------------------------------

def _resolve_bitmap_responses(chips, cmds, placements, out,
                              matches_of) -> int:
    """Resolve bitmap-shaped (search / plan) tickets from launch output.

    ``placements[i]`` is the ``(row, pi)`` cell of command i's bitmap in
    ``out``.  Commands that dedup'd into the same launch cell share ONE
    host copy of the bitmap (and its popcount), detached from ``out``.
    ``matches_of(cmd)`` is the on-chip match-op count the command's chip
    executed (1 for a search, ``n_passes`` for a plan).  Returns result
    bytes: 64 B per unique cell (shared cells cross once).
    """
    cache: dict[tuple, SearchResponse] = {}
    for (cmd, ticket), idx in zip(cmds, placements):
        resp = cache.get(idx)
        if resp is None:
            raw = np.array(out[idx], copy=True)
            resp = cache[idx] = SearchResponse(
                bitmap_words=raw, match_count=int(popcount_words(raw).sum()),
                open_verdict=OpenVerdict.CLEAN.value)
        chip, _ = chips.route(cmd.page_addr)
        chip.counters.searches += matches_of(cmd)
        ticket._resolve(resp)
    return 64 * len(cache)


def resolve_search_responses(chips, searches, placements, out) -> int:
    return _resolve_bitmap_responses(chips, searches, placements, out,
                                     lambda cmd: 1)


def resolve_plan_responses(chips, plans, placements, out) -> int:
    """A PLAN's chip executed ``n_passes`` match ops, but only the one
    combined 64 B bitmap per unique cell crossed — the Fig 10 win."""
    return _resolve_bitmap_responses(chips, plans, placements, out,
                                     lambda cmd: cmd.n_passes)


def snapshot_parities(chips, addrs) -> dict:
    """Flush-time copy of each page's inner-code parities.

    Lazy host tails verify CRCs at drain time, which may be AFTER a
    reprogram of one of the burst's pages; the launch itself read the
    pre-write planes, so the verification must compare against the
    parities as of flush, not whatever the chip holds at drain.
    """
    snap = {}
    for a in set(addrs):
        chip, local = chips.route(a)
        snap[int(a)] = chip.pages[local].chunk_parities.copy()
    return snap


def resolve_lookup_responses(chips, lookups, bm, val, slots,
                             parity_snap) -> int:
    """Fused-lookup host tail: batched de-randomize + inner-code verify of
    every hit's value chunk, then ticket resolution.

    ``bm`` (n, 16), ``val`` (n, 16), ``slots`` (n,) are the launch outputs
    trimmed to the burst length; ``parity_snap`` maps each value page to
    its flush-time ``snapshot_parities`` row.
    """
    n = len(lookups)
    key_addrs = [cmd.page_addr for cmd, _ in lookups]
    val_addrs = [cmd.value_page for cmd, _ in lookups]
    counts = popcount_words(bm)                # (n,) per-row match totals

    for a in set(key_addrs):
        chip, _ = chips.route(a)
        chip.counters.array_reads += 1

    hit = slots < NO_SLOT
    hit_idx = np.nonzero(hit)[0]
    values = [None] * n
    parity = np.ones(n, dtype=bool)
    if hit_idx.size:
        v_locals, v_seeds, parities = [], [], []
        chunks = slots[hit_idx] // SLOTS_PER_CHUNK
        for i, c in zip(hit_idx, chunks):
            chip, local = chips.route(val_addrs[int(i)])
            v_locals.append(local)
            v_seeds.append(chip.device_seed & 0xFFFFFFFF)
            parities.append(parity_snap[int(val_addrs[int(i)])][int(c)])
            chip.counters.array_reads += 1
            chip.counters.gathers += 1
            chip.counters.chunks_gathered += 1
        streams = chunk_stream_words_batch(v_locals, chunks, v_seeds)
        words = val[hit_idx].reshape(-1, SLOTS_PER_CHUNK, 2)
        plain = slot_words_to_bytes(words ^ streams)       # (K, 64) bytes
        parity[hit_idx] = (ecc.crc32_rows(plain)
                           == np.asarray(parities, np.uint32))
        offs = (slots[hit_idx] % SLOTS_PER_CHUNK) * 8
        for j, i in enumerate(hit_idx):
            values[int(i)] = bytes(plain[j, offs[j]:offs[j] + 8])

    for i, (cmd, ticket) in enumerate(lookups):
        chip, _ = chips.route(cmd.page_addr)
        chip.counters.searches += 1
        resp = SearchResponse(bitmap_words=bm[i].copy(),
                              match_count=int(counts[i]),
                              open_verdict=OpenVerdict.CLEAN.value)
        ticket._resolve(LookupResponse(
            search=resp,
            value_slot=int(slots[i]) if hit[i] else None,
            value=values[i], parity_ok=bool(parity[i])))
    return 64 * n + 64 * int(hit_idx.size)


def resolve_gather_responses(chips, gathers, out, parity_snap) -> int:
    """Gather host tail: one stream regeneration + one CRC pass for every
    selected chunk of the whole burst.  ``parity_snap`` holds each page's
    flush-time ``snapshot_parities`` row.  Returns result bytes (64 B per
    gathered chunk)."""
    owners, all_locals, all_chunks, all_seeds, all_parities = \
        [], [], [], [], []
    chunk_ids_per = []
    for cmd, _ in gathers:
        chip, local = chips.route(cmd.page_addr)
        owners.append(chip)
        bits = unpack_bitmap(np.asarray(cmd.chunk_bitmap, np.uint32),
                             n_bits=CHUNKS_PER_PAGE)
        chunk_ids = np.nonzero(bits)[0]
        chunk_ids_per.append(chunk_ids)
        all_locals.extend([local] * chunk_ids.size)
        all_chunks.extend(chunk_ids.tolist())
        all_seeds.extend([chip.device_seed & 0xFFFFFFFF] * chunk_ids.size)
        all_parities.append(parity_snap[int(cmd.page_addr)][chunk_ids])

    k_total = len(all_chunks)
    if k_total:
        words = np.concatenate([
            out[r, :ids.size] for r, ids in enumerate(chunk_ids_per)
            if ids.size]).reshape(k_total, SLOTS_PER_CHUNK, 2)
        streams = chunk_stream_words_batch(all_locals, all_chunks, all_seeds)
        plain_all = slot_words_to_bytes(words ^ streams)
        parity_all = (ecc.crc32_rows(plain_all)
                      == np.concatenate(all_parities))
    else:
        plain_all = np.zeros((0, CHUNK_BYTES), dtype=np.uint8)
        parity_all = np.zeros(0, dtype=bool)

    pos = 0
    for r, (cmd, ticket) in enumerate(gathers):
        chip = owners[r]
        chunk_ids = chunk_ids_per[r]
        k = int(chunk_ids.size)
        chip.counters.array_reads += 1
        chip.counters.gathers += 1
        chip.counters.chunks_gathered += k
        ticket._resolve(GatherResponse(chunks=plain_all[pos:pos + k],
                                       chunk_ids=chunk_ids,
                                       parity_ok=parity_all[pos:pos + k]))
        pos += k
    return 64 * k_total


class BatchedKernelBackend(MatchBackend):
    """One launch per flush phase over a device-resident plane arena.

    ``device=None`` runs on the current CUDA device and raises when there
    is none; ``device="cpu"`` runs the plain PyTorch versions of the
    kernels.
    """

    def __init__(self, chips: SimChipArray, *, device=None):
        super().__init__(chips)
        self.store = PlaneStore(chips, block=PAGE_BLOCK, device=device)
        self.device = self.store.device
        self._searches: list[tuple[Command, Ticket]] = []
        self._gathers: list[tuple[Command, Ticket]] = []
        self._lookups: list[tuple[Command, Ticket]] = []
        self._plans: list[tuple[Command, Ticket]] = []

    # ------------------------------------------------------------ deferred
    def submit_search(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.SEARCH or cmd.query is None or cmd.mask is None:
            raise ValueError(f"not a search command: {cmd}")
        t = Ticket(self)
        self._searches.append((cmd, t))
        return t

    def submit_gather(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.GATHER or cmd.chunk_bitmap is None:
            raise ValueError(f"not a gather command: {cmd}")
        t = Ticket(self)
        self._gathers.append((cmd, t))
        return t

    def submit_lookup(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.LOOKUP or cmd.value_page is None:
            raise ValueError(f"not a lookup command: {cmd}")
        t = Ticket(self)
        self._lookups.append((cmd, t))
        return t

    def submit_plan(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.PLAN or cmd.plan_include is None:
            raise ValueError(f"not a plan command: {cmd}")
        t = Ticket(self)
        self._plans.append((cmd, t))
        return t

    @property
    def pending(self) -> int:
        return (len(self._searches) + len(self._gathers)
                + len(self._lookups) + len(self._plans)
                + self.pending_programs)

    def flush(self) -> None:
        # Deferred programs first: one grouped chip-program pass, then ONE
        # plane-store scatter re-stages every programmed row.
        programs = self._execute_programs()
        if programs:
            self.store.stage_group(programs)
            self.stats.staged_bytes = self.store.staged_bytes
        if not (self._searches or self._gathers or self._lookups
                or self._plans):
            if programs:
                self.stats.flushes += 1
            return
        self.stats.flushes += 1
        searches, self._searches = self._searches, []
        lookups, self._lookups = self._lookups, []
        gathers, self._gathers = self._gathers, []
        plans, self._plans = self._plans, []
        if searches:
            self._flush_searches(searches)
        if plans:
            self._flush_plans(plans)
        if lookups:
            self._flush_lookups(lookups)
        if gathers:
            self._flush_gathers(gathers)
        # The plane store is the only source of host->device page traffic.
        self.stats.staged_bytes = self.store.staged_bytes

    # ------------------------------------------------------------- staging
    def _flush_searches(self, searches) -> None:
        # Unique pages -> arena rows; unique (query, mask) -> operand rows.
        page_rows: dict[int, int] = {}
        query_rows: dict[tuple, int] = {}
        addrs: list[int] = []
        q_pairs, m_pairs = [], []
        placements = []                        # (qi, pi) per command
        for cmd, _ in searches:
            if cmd.page_addr not in page_rows:
                page_rows[cmd.page_addr] = len(addrs)
                addrs.append(cmd.page_addr)
            key = (cmd.query, cmd.mask)
            if key not in query_rows:
                query_rows[key] = len(q_pairs)
                q_pairs.append(cmd.query)
                m_pairs.append(cmd.mask)
            placements.append((query_rows[key], page_rows[cmd.page_addr]))

        rows = self.store.rows_for(addrs)      # stages new + dirty only
        # One staged sense per unique page, amortized over all queries.
        for a in addrs:
            chip, _ = self.chips.route(a)
            chip.counters.array_reads += 1

        n_pages = padded_rows(len(addrs), PAGE_BLOCK)
        lo, hi, page_ids, page_seeds = self.store.take(rows, n_pages)
        n_queries = len(q_pairs)
        q = np.zeros((next_pow2(n_queries), 2), dtype=np.uint32)
        m = np.zeros_like(q)
        q[:n_queries] = np.asarray(q_pairs, dtype=np.uint32)
        m[:n_queries] = np.asarray(m_pairs, dtype=np.uint32)

        out = sim_search(lo, hi, words_to_tensor(q, self.device),
                         words_to_tensor(m, self.device), page_ids,
                         page_seeds, randomized=True)  # (Qpad, Npad, 16)

        self.stats.kernel_launches += 1
        self.stats.staged_pages += len(addrs)
        self.stats.staged_queries += n_queries
        self.stats.searches += len(searches)
        if len(searches) > 1:
            self.stats.batched_searches += len(searches)

        def tail(out=out, searches=searches, placements=placements):
            self.stats.result_bytes += resolve_search_responses(
                self.chips, searches, placements, tensor_to_words(out))
        self._defer_all(searches, tail)

    # ---------------------------------------------------------------- plans
    def _flush_plans(self, plans) -> None:
        """Fused multi-pass range plans: one launch, one 64 B bitmap a cell.

        Unique pages dedup to arena rows exactly like searches; unique
        (include, exclude) pass tuples dedup to plan *groups* (commands
        sharing both land on the same launch cell).  Pass rows and groups
        pad to powers of two, page rows to ``padded_rows``.
        """
        page_rows: dict[int, int] = {}
        group_rows: dict[tuple, int] = {}
        addrs: list[int] = []
        groups: list[tuple] = []
        placements = []                        # (gi, pi) per command
        for cmd, _ in plans:
            if cmd.page_addr not in page_rows:
                page_rows[cmd.page_addr] = len(addrs)
                addrs.append(cmd.page_addr)
            key = (cmd.plan_include, cmd.plan_exclude)
            if key not in group_rows:
                group_rows[key] = len(groups)
                groups.append(key)
            placements.append((group_rows[key], page_rows[cmd.page_addr]))

        rows = self.store.rows_for(addrs)
        for a in addrs:                        # one staged sense per page,
            chip, _ = self.chips.route(a)      # amortized over every pass
            chip.counters.array_reads += 1

        n_pages = padded_rows(len(addrs), PAGE_BLOCK)
        lo, hi, page_ids, page_seeds = self.store.take(rows, n_pages)
        n_passes = [len(i) + len(e) for i, e in groups]
        p_pad = next_pow2(max(max(n_passes), 1))
        g_pad = next_pow2(len(groups))
        q = np.zeros((g_pad, p_pad, 2), dtype=np.uint32)
        m = np.zeros_like(q)
        f = np.zeros((g_pad, p_pad), dtype=np.uint32)
        for gi, (inc, exc) in enumerate(groups):
            q[gi], m[gi], f[gi] = plan_pass_rows(inc, exc, p_pad)

        out = sim_plan(lo, hi, words_to_tensor(q, self.device),
                       words_to_tensor(m, self.device),
                       words_to_tensor(f, self.device), page_ids, page_seeds,
                       randomized=True)        # (Gpad, Npad, 16)

        self.stats.kernel_launches += 1
        self.stats.staged_pages += len(addrs)
        self.stats.staged_queries += sum(n_passes)
        self.stats.plans += len(plans)

        def tail(out=out, plans=plans, placements=placements):
            self.stats.result_bytes += resolve_plan_responses(
                self.chips, plans, placements, tensor_to_words(out))
        self._defer_all(plans, tail)

    # -------------------------------------------------------------- lookups
    def _flush_lookups(self, lookups) -> None:
        """Fused read burst: search + slot select + value gather, 1 launch."""
        key_addrs = [cmd.page_addr for cmd, _ in lookups]
        val_addrs = [cmd.value_page for cmd, _ in lookups]
        k_rows = self.store.rows_for(key_addrs)
        v_rows = self.store.rows_for(val_addrs)

        n = len(lookups)
        n_pad = padded_rows(n, LOOKUP_BLOCK)
        klo, khi, kids, kseeds = self.store.take(k_rows, n_pad)
        vlo, vhi, _, _ = self.store.take(v_rows, n_pad)
        q = np.zeros((n_pad, 2), dtype=np.uint32)
        m = np.full((n_pad, 2), 0xFFFFFFFF, dtype=np.uint32)  # pad rows miss
        q[:n] = np.asarray([cmd.query for cmd, _ in lookups], np.uint32)
        m[:n] = np.asarray([cmd.mask for cmd, _ in lookups], np.uint32)

        bm, val, slots = sim_fused_lookup(
            klo, khi, vlo, vhi, words_to_tensor(q, self.device),
            words_to_tensor(m, self.device), kids, kseeds, randomized=True)

        self.stats.kernel_launches += 1
        self.stats.lookups += n
        self.stats.staged_pages += len(set(key_addrs) | set(val_addrs))
        self.stats.staged_queries += n
        snap = snapshot_parities(self.chips, val_addrs)

        def tail(bm=bm, val=val, slots=slots, lookups=lookups, n=n,
                 snap=snap):
            self.stats.result_bytes += resolve_lookup_responses(
                self.chips, lookups, tensor_to_words(bm)[:n],
                tensor_to_words(val)[:n], slots.cpu().numpy()[:n], snap)
        self._defer_all(lookups, tail)

    # -------------------------------------------------------------- gathers
    def _flush_gathers(self, gathers) -> None:
        addrs = [cmd.page_addr for cmd, _ in gathers]
        rows = self.store.rows_for(addrs)
        n = len(gathers)
        n_pad = padded_rows(n, PAGE_BLOCK)
        lo, hi, _, _ = self.store.take(rows, n_pad)
        chunk_words = planes_to_chunk_words(lo, hi)        # (Npad, 64, 16)
        bm = np.zeros((n_pad, 2), dtype=np.uint32)
        bm[:n] = np.asarray([cmd.chunk_bitmap for cmd, _ in gathers],
                            np.uint32)
        out, _counts = sim_gather(chunk_words,
                                  words_to_tensor(bm, self.device),
                                  max_out=CHUNKS_PER_PAGE)
        self.stats.kernel_launches += 1
        self.stats.gathers += n
        snap = snapshot_parities(self.chips, addrs)

        def tail(out=out, gathers=gathers, n=n, snap=snap):
            self.stats.result_bytes += resolve_gather_responses(
                self.chips, gathers, tensor_to_words(out)[:n], snap)
        self._defer_all(gathers, tail)
