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

At flush time the deferred queues become device operands:

  * every *unique* page touched by a queued search becomes one arena-row
    index, and the kernel reads that row of the arena in place (one
    host->device copy of the indices, no gather); it regenerates the
    §IV-C1 randomization stream from the row's address/seed (stored
    images are staged as-is);
  * every *unique* (query, mask) pair becomes one row of the (Q, 2) query
    operands — Q queries match against N pages in a single ``sim_search``
    launch, the §IV-E cross-page multi-query batch;
  * queued gathers become one arena-row index each, and one ``sim_gather``
    launch reads the selected chunks of those rows in place and compacts
    them; de-randomization and inner-code verification of the selected
    chunks happen host-side, batched over the whole burst;
  * queued lookups (Op.LOOKUP) run the fused lookup kernel: key-page
    search, first-matching-user-slot selection, and the paired value page's
    same-slot chunk gather all happen in ONE launch, reading key and value
    rows of the arena in place through one upload of both index sets;
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

Without a reliability tier attached, ``SearchResponse.open_verdict``
always reads CLEAN here.  With ``enable_reliability`` the flush runs the
same optimistic open burst as the scalar reference before any row is
staged — verdicts, ECC fallback repairs (restaged in the same flush),
voting and selective verification in the host tails — and uncorrectable
pages fail their tickets with a typed error.  The launches themselves do
not change.
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.kernels.layout import tensor_to_words, words_to_tensor
from repro_torch.kernels.sim_fused.ops import sim_fused_lookup
from repro_torch.kernels.sim_fused.ref import NO_SLOT
from repro_torch.kernels.sim_gather.ops import sim_gather
from repro_torch.kernels.sim_plan.ops import sim_plan
from repro_torch.kernels.sim_plan.ref import plan_pass_rows
from repro_torch.kernels.sim_search.ops import sim_search
from repro_torch.reliability.errors import UncorrectableReadError

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

def _resolve_bitmap_responses(chips, cmds, placements, out, matches_of,
                              reliability=None, opens=None,
                              is_plan=False, verdicts=None) -> int:
    """Resolve bitmap-shaped (search / plan) tickets from launch output.

    ``placements[i]`` is the ``(row, pi)`` cell of command i's bitmap in
    ``out``.  Commands that dedup'd into the same launch cell share ONE
    host copy of the bitmap (and its popcount), detached from ``out``.
    ``matches_of(cmd)`` is the on-chip match-op count the command's chip
    executed (1 for a search, ``n_passes`` for a plan).  Returns result
    bytes: 64 B per unique cell that resolved (shared cells cross once).

    With a reliability tier attached, each unique cell's raw bitmap runs
    the vote/verify/fallback finalize against the flush's captured page
    opens; an uncorrectable page fails every ticket of the cell with the
    typed error instead of resolving.  Without it, ``verdicts`` (one a
    command: a sharded failover burst's latch verdicts) replace the CLEAN
    verdict of the raw responses.
    """
    cache: dict[tuple, tuple] = {}
    n_ok = 0
    for i, ((cmd, ticket), idx) in enumerate(zip(cmds, placements)):
        entry = cache.get(idx)
        if entry is None:
            raw = np.array(out[idx], copy=True)
            if reliability is None:
                entry = ("ok", SearchResponse(
                    bitmap_words=raw,
                    match_count=int(popcount_words(raw).sum()),
                    open_verdict=OpenVerdict.CLEAN.value))
            else:
                fin = (reliability.finalize_plan if is_plan
                       else reliability.finalize_search)
                try:
                    entry = ("ok", fin(chips, cmd, raw, opens))
                except UncorrectableReadError as e:
                    entry = ("err", e)
            cache[idx] = entry
            n_ok += entry[0] == "ok"
        chip, _ = chips.route(cmd.page_addr)
        chip.counters.searches += matches_of(cmd)
        if entry[0] == "ok":
            resp = entry[1]
            if verdicts is not None:
                resp = dataclasses.replace(resp, open_verdict=verdicts[i])
            ticket._resolve(resp)
        else:
            ticket._fail(entry[1])
    return 64 * n_ok


def resolve_search_responses(chips, searches, placements, out,
                             reliability=None, opens=None,
                             verdicts=None) -> int:
    return _resolve_bitmap_responses(chips, searches, placements, out,
                                     lambda cmd: 1, reliability, opens,
                                     verdicts=verdicts)


def resolve_plan_responses(chips, plans, placements, out,
                           reliability=None, opens=None,
                           verdicts=None) -> int:
    """A PLAN's chip executed ``n_passes`` match ops, but only the one
    combined 64 B bitmap per unique cell crossed — the Fig 10 win."""
    return _resolve_bitmap_responses(chips, plans, placements, out,
                                     lambda cmd: cmd.n_passes, reliability,
                                     opens, is_plan=True, verdicts=verdicts)


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
                             parity_snap, reliability=None,
                             opens=None, verdicts=None) -> int:
    """Fused-lookup host tail: batched de-randomize + inner-code verify of
    every hit's value chunk, then ticket resolution.

    ``bm`` (n, 16), ``val`` (n, 16), ``slots`` (n,) are the launch outputs
    trimmed to the burst length; ``parity_snap`` maps each value page to
    its flush-time ``snapshot_parities`` row.

    With a reliability tier attached the on-device slot select and value
    gather are advisory only: the finalize path re-derives the slot from
    the voted/verified key bitmap and host-reads the value chunk from the
    current image, so every backend serves byte-identical values under a
    fault seed.  Without it, ``verdicts`` (one a lookup: a sharded
    failover burst's latch verdicts) replace the CLEAN verdict.
    """
    if reliability is not None:
        return _resolve_lookups_reliable(chips, lookups, bm, reliability,
                                         opens)
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
                              open_verdict=(OpenVerdict.CLEAN.value
                                            if verdicts is None
                                            else verdicts[i]))
        ticket._resolve(LookupResponse(
            search=resp,
            value_slot=int(slots[i]) if hit[i] else None,
            value=values[i], parity_ok=bool(parity[i])))
    return 64 * n + 64 * int(hit_idx.size)


def _resolve_lookups_reliable(chips, lookups, bm, reliability, opens) -> int:
    """Reliability tail for a lookup burst: finalize each key bitmap
    (vote + selective verification + miss fallback) and serve the value
    through the inner-code-checked host read."""
    nbytes = 0
    for a in {cmd.page_addr for cmd, _ in lookups}:
        chip, _ = chips.route(a)
        chip.counters.array_reads += 1
    for i, (cmd, ticket) in enumerate(lookups):
        chip, _ = chips.route(cmd.page_addr)
        chip.counters.searches += 1
        try:
            resp = reliability.finalize_lookup(
                chips, cmd, np.array(bm[i], copy=True), opens)
        except UncorrectableReadError as e:
            ticket._fail(e)
            continue
        ticket._resolve(resp)
        nbytes += 64 + (64 if resp.value_slot is not None else 0)
    return nbytes


def resolve_gather_responses(chips, gathers, out, parity_snap,
                             reliability=None, opens=None) -> int:
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
        resp = GatherResponse(chunks=plain_all[pos:pos + k],
                              chunk_ids=chunk_ids,
                              parity_ok=parity_all[pos:pos + k])
        pos += k
        if reliability is not None:
            try:
                resp = reliability.finalize_gather(chips, cmd, resp, opens)
            except UncorrectableReadError as e:
                ticket._fail(e)
                continue
        ticket._resolve(resp)
    return 64 * k_total

# ---------------------------------------------------------------------------
# Row-stacked launches, shared with the sharded backend: row i of a lookup
# burst reads key row i and value row i of the arena in place, row i of a
# gather burst reads its page's row.  Each issues ONE index upload and ONE
# launch and defers the host tail to the first ``result()`` of the burst;
# the calling ``_flush_*`` phase counts the launch in ``be.stats`` (the
# tail adds the result bytes).  ``block`` is the backend's padded row block;
# ``rel`` is the reliability tier the tail finalizes with (None for raw
# responses) and ``opens`` the flush's page opens, both captured into the
# tail; ``verdicts`` are a sharded failover burst's latch verdicts.
# ---------------------------------------------------------------------------

def launch_lookups(be, lookups, block: int, rel, opens,
                   verdicts=None) -> int:
    """Fused read burst: search + slot select + value gather, 1 launch.
    Returns the unique key and value pages the launch read."""
    key_addrs = [cmd.page_addr for cmd, _ in lookups]
    val_addrs = [cmd.value_page for cmd, _ in lookups]
    k_rows = be.store.rows_for(key_addrs)
    v_rows = be.store.rows_for(val_addrs)

    n = len(lookups)
    n_pad = padded_rows(n, block)
    key_idx, value_idx = be.store.upload_rows(k_rows, v_rows, pad_to=n_pad)
    q = np.zeros((n_pad, 2), dtype=np.uint32)
    m = np.full((n_pad, 2), 0xFFFFFFFF, dtype=np.uint32)  # pad rows miss
    q[:n] = np.asarray([cmd.query for cmd, _ in lookups], np.uint32)
    m[:n] = np.asarray([cmd.mask for cmd, _ in lookups], np.uint32)

    # Key and value pages are read in place from the one arena.
    lo, hi, ids, seeds = be.store.arena()
    bm, val, slots = sim_fused_lookup(
        lo, hi, lo, hi, words_to_tensor(q, be.device),
        words_to_tensor(m, be.device), ids, seeds, randomized=True,
        key_rows=key_idx, value_rows=value_idx)

    snap = snapshot_parities(be.chips, val_addrs)

    def tail(bm=bm, val=val, slots=slots, lookups=lookups, n=n, snap=snap,
             rel=rel, opens=opens, verdicts=verdicts):
        be.stats.result_bytes += resolve_lookup_responses(
            be.chips, lookups, tensor_to_words(bm)[:n],
            tensor_to_words(val)[:n], slots.cpu().numpy()[:n], snap,
            rel, opens, verdicts)
    be._defer_all(lookups, tail)
    return len(set(key_addrs) | set(val_addrs))


def launch_gathers(be, gathers, block: int, rel, opens) -> None:
    """Bitmap-selected chunk gather of every queued page, 1 launch."""
    addrs = [cmd.page_addr for cmd, _ in gathers]
    rows = be.store.rows_for(addrs)
    n = len(gathers)
    n_pad = padded_rows(n, block)
    row_idx, = be.store.upload_rows(rows, pad_to=n_pad)
    bm = np.zeros((n_pad, 2), dtype=np.uint32)   # pad rows gather nothing
    bm[:n] = np.asarray([cmd.chunk_bitmap for cmd, _ in gathers], np.uint32)
    # The kernel reads the arena's rows in place: no gather copies.
    lo, hi, _, _ = be.store.arena()
    out, _counts = sim_gather(lo, hi, words_to_tensor(bm, be.device),
                              max_out=CHUNKS_PER_PAGE,
                              rows=row_idx)    # (Npad, 64, 16)
    snap = snapshot_parities(be.chips, addrs)

    def tail(out=out, gathers=gathers, n=n, snap=snap, rel=rel,
             opens=opens):
        be.stats.result_bytes += resolve_gather_responses(
            be.chips, gathers, tensor_to_words(out)[:n], snap, rel, opens)
    be._defer_all(gathers, tail)


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
        # Reliability open burst BEFORE any staging: open-time ECC repairs
        # mark their plane rows dirty, so rows_for re-stages the corrected
        # images in this same flush.  The verdict dict is captured into the
        # phase tails — later flushes may re-open these pages before the
        # lazy tails run.
        opens = self._open_reliability(
            {c.page_addr for c, _ in searches}
            | {c.page_addr for c, _ in plans}
            | {c.page_addr for c, _ in gathers}
            | {c.page_addr for c, _ in lookups}
            | {c.value_page for c, _ in lookups})
        if searches:
            self._flush_searches(searches, opens)
        if plans:
            self._flush_plans(plans, opens)
        if lookups:
            self._flush_lookups(lookups, opens)
        if gathers:
            self._flush_gathers(gathers, opens)
        # The plane store is the only source of host->device page traffic.
        self.stats.staged_bytes = self.store.staged_bytes

    # ------------------------------------------------------------- staging
    def _flush_searches(self, searches, opens) -> None:
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
        page_rows_idx, = self.store.upload_rows(rows, pad_to=n_pages)
        n_queries = len(q_pairs)
        q = np.zeros((next_pow2(n_queries), 2), dtype=np.uint32)
        m = np.zeros_like(q)
        q[:n_queries] = np.asarray(q_pairs, dtype=np.uint32)
        m[:n_queries] = np.asarray(m_pairs, dtype=np.uint32)

        # The kernel reads the arena's rows in place: no gather copies.
        lo, hi, ids, seeds = self.store.arena()
        out = sim_search(lo, hi, words_to_tensor(q, self.device),
                         words_to_tensor(m, self.device), ids, seeds,
                         randomized=True,
                         rows=page_rows_idx)   # (Qpad, Npad, 16)

        self.stats.kernel_launches += 1
        self.stats.staged_pages += len(addrs)
        self.stats.staged_queries += n_queries
        self.stats.searches += len(searches)
        if len(searches) > 1:
            self.stats.batched_searches += len(searches)

        def tail(out=out, searches=searches, placements=placements,
                 rel=self.reliability, opens=opens):
            self.stats.result_bytes += resolve_search_responses(
                self.chips, searches, placements, tensor_to_words(out),
                rel, opens)
        self._defer_all(searches, tail)

    # ------------------------------------------------------ lookups, gathers
    def _flush_lookups(self, lookups, opens) -> None:
        staged_pages = launch_lookups(self, lookups, LOOKUP_BLOCK,
                                      self.reliability, opens)
        self.stats.kernel_launches += 1
        self.stats.lookups += len(lookups)
        self.stats.staged_pages += staged_pages
        self.stats.staged_queries += len(lookups)

    def _flush_gathers(self, gathers, opens) -> None:
        launch_gathers(self, gathers, PAGE_BLOCK, self.reliability, opens)
        self.stats.kernel_launches += 1
        self.stats.gathers += len(gathers)

    # ---------------------------------------------------------------- plans
    def _flush_plans(self, plans, opens) -> None:
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

        def tail(out=out, plans=plans, placements=placements,
                 rel=self.reliability, opens=opens):
            self.stats.result_bytes += resolve_plan_responses(
                self.chips, plans, placements, tensor_to_words(out), rel,
                opens)
        self._defer_all(plans, tail)

