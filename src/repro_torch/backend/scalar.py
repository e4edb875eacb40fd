"""Reference MatchBackend: queued commands execute one page at a time.

This is the numpy ``SimChip`` path behind the deferred-submission
interface.  Every queued command walks the full functional model — latch
pipeline, optimistic-open verdicts, ECC fallback — so it remains the
bit-exact oracle the batched backend is validated against.  It runs on the
host only: no tensor, no kernel.
A queued LOOKUP executes as the paper's §V-A command pair — a key-page
search followed by a gather of the first matching user slot's chunk on the
paired value page — through the same chip model, so it is the bit-exact
oracle for the batched backend's fused single-launch lookup path.
A queued PLAN executes as the per-pass split: one chip search per
include/exclude pass, OR/AND-NOT combined on the controller — the
bit-exact reference for the fused in-latch ``sim_plan`` kernel.
``BackendStats.result_bytes`` still counts only the combined 64 B bitmap
per plan (what a SiM chip would transmit), not the per-pass payloads.

With a reliability tier attached (``enable_reliability``) the flush opens
every unique page once, executes the whole burst raw, then runs the
vote / verify / fallback finalize per response (``_flush_reliable``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bits import SLOTS_PER_CHUNK, popcount_words, unpack_bitmap
from repro_torch.core.commands import (Command, LookupResponse, Op,
                                       SearchResponse)
from repro_torch.core.ecc import OpenVerdict
from repro_torch.core.engine import SimChipArray
from repro_torch.core.page import mask_header_slots
from repro_torch.reliability.errors import UncorrectableReadError

from .base import MatchBackend, Ticket


class ScalarBackend(MatchBackend):
    def __init__(self, chips: SimChipArray):
        super().__init__(chips)
        self._queue: list[tuple[str, Command, Ticket]] = []

    def submit_search(self, cmd: Command) -> Ticket:
        t = Ticket(self)
        self._queue.append(("search", cmd, t))
        return t

    def submit_gather(self, cmd: Command) -> Ticket:
        t = Ticket(self)
        self._queue.append(("gather", cmd, t))
        return t

    def submit_lookup(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.LOOKUP or cmd.value_page is None:
            raise ValueError(f"not a lookup command: {cmd}")
        t = Ticket(self)
        self._queue.append(("lookup", cmd, t))
        return t

    def submit_plan(self, cmd: Command) -> Ticket:
        if cmd.op is not Op.PLAN or cmd.plan_include is None:
            raise ValueError(f"not a plan command: {cmd}")
        t = Ticket(self)
        self._queue.append(("plan", cmd, t))
        return t

    @property
    def pending(self) -> int:
        return len(self._queue) + self.pending_programs

    def flush(self) -> None:
        # Deferred programs run first (coalesced last-wins per page), so
        # commands flushed alongside them match against the new images —
        # identical ordering to the batched backend's grouped program phase.
        programs = self._execute_programs()
        queue, self._queue = self._queue, []
        if not queue:
            if programs:
                self.stats.flushes += 1
            return
        self.stats.flushes += 1
        if self.reliability is not None:
            self._flush_reliable(queue)
            return
        for kind, cmd, ticket in queue:
            if kind == "search":
                ticket._resolve(self.chips.search(cmd))
                self.stats.searches += 1
                self.stats.result_bytes += 64
            elif kind == "lookup":
                resp = self._lookup(cmd)
                ticket._resolve(resp)
                self.stats.lookups += 1
                self.stats.result_bytes += 64 + (64 if resp.value_slot
                                                 is not None else 0)
            elif kind == "plan":
                ticket._resolve(self._plan(cmd))
                self.stats.plans += 1
                self.stats.result_bytes += 64      # the combined bitmap only
            else:
                resp = self.chips.gather(cmd)
                ticket._resolve(resp)
                self.stats.gathers += 1
                self.stats.result_bytes += 64 * len(resp.chunk_ids)

    def _flush_reliable(self, queue) -> None:
        """Reliability-tier flush: ONE optimistic open per unique page (the
        same staged-open discipline as the kernel backends), raw execution
        against the possibly open-repaired images, then the shared
        vote/verify/fallback finalize per response.

        Raw execution runs for the WHOLE burst before any finalize step, so
        resolve-time repairs (verification failures, lookup-miss
        escalations) cannot retroactively change a burst peer's raw bitmap
        — exactly the ordering a single kernel launch imposes.
        """
        rel = self.reliability
        addrs = set()
        for _, cmd, _ in queue:
            addrs.add(cmd.page_addr)
            if cmd.value_page is not None:
                addrs.add(cmd.value_page)
        opens = rel.open_burst(self.chips, addrs)

        def dead(cmd):
            if opens[cmd.page_addr].verdict is OpenVerdict.UNCORRECTABLE:
                return cmd.page_addr
            if cmd.value_page is not None and \
                    opens[cmd.value_page].verdict is OpenVerdict.UNCORRECTABLE:
                return cmd.value_page
            return None

        raws = []
        for kind, cmd, _ in queue:
            if dead(cmd) is not None:
                raws.append(None)
            elif kind == "search":
                raws.append(self.chips.search(cmd).bitmap_words)
            elif kind == "lookup":
                raws.append(self.chips.search(Command(
                    Op.SEARCH, cmd.page_addr, query=cmd.query,
                    mask=cmd.mask)).bitmap_words)
            elif kind == "plan":
                raws.append(self._plan(cmd).bitmap_words)
            else:
                raws.append(self.chips.gather(cmd))

        finalize = {"search": rel.finalize_search,
                    "lookup": rel.finalize_lookup,
                    "plan": rel.finalize_plan,
                    "gather": rel.finalize_gather}
        for (kind, cmd, ticket), raw in zip(queue, raws):
            try:
                if raw is None:
                    raise UncorrectableReadError(dead(cmd))
                resp = finalize[kind](self.chips, cmd, raw, opens)
                ticket._resolve(resp)
                if kind == "lookup":
                    self.stats.result_bytes += 64 + (
                        64 if resp.value_slot is not None else 0)
                elif kind == "gather":
                    self.stats.result_bytes += 64 * len(resp.chunk_ids)
                else:
                    self.stats.result_bytes += 64
            except UncorrectableReadError as e:
                ticket._fail(e)
            if kind == "search":
                self.stats.searches += 1
            elif kind == "lookup":
                self.stats.lookups += 1
            elif kind == "plan":
                self.stats.plans += 1
            else:
                self.stats.gathers += 1

    # Open-verdict severity, worst-wins across a plan's passes.
    _VERDICT_RANK = {v.value: i for i, v in enumerate((
        OpenVerdict.CLEAN, OpenVerdict.CLEAN_NEEDS_REFRESH,
        OpenVerdict.FALLBACK_ECC, OpenVerdict.UNCORRECTABLE))}

    def _plan(self, cmd: Command) -> SearchResponse:
        """Per-pass split reference for Op.PLAN: one full chip search per
        include/exclude pass, combined OR-then-AND-NOT exactly as the
        latch accumulation would (paper Fig 10).  Reports the worst
        (most severe) open verdict any pass saw."""
        acc = np.zeros(16, dtype=np.uint32)
        verdict = OpenVerdict.CLEAN.value
        for q, mk in cmd.plan_include:
            r = self.chips.search(Command(Op.SEARCH, cmd.page_addr,
                                          query=q, mask=mk))
            acc |= r.bitmap_words
            verdict = max(verdict, r.open_verdict,
                          key=self._VERDICT_RANK.__getitem__)
        for q, mk in cmd.plan_exclude:
            r = self.chips.search(Command(Op.SEARCH, cmd.page_addr,
                                          query=q, mask=mk))
            acc &= ~r.bitmap_words
            verdict = max(verdict, r.open_verdict,
                          key=self._VERDICT_RANK.__getitem__)
        return SearchResponse(bitmap_words=acc,
                              match_count=int(popcount_words(acc).sum()),
                              open_verdict=verdict)

    def _lookup(self, cmd: Command) -> LookupResponse:
        resp = self.chips.search(Command(Op.SEARCH, cmd.page_addr,
                                         query=cmd.query, mask=cmd.mask))
        bitmap = mask_header_slots(resp.bitmap_words)
        slots = np.nonzero(unpack_bitmap(bitmap, 512))[0]
        if slots.size == 0:
            return LookupResponse(search=resp, value_slot=None, value=None)
        slot = int(slots[0])
        g = self.chips.gather(Command.gather(cmd.value_page,
                                             1 << (slot // SLOTS_PER_CHUNK)))
        off = (slot % SLOTS_PER_CHUNK) * 8
        return LookupResponse(search=resp, value_slot=slot,
                              value=bytes(g.chunks[0][off:off + 8]),
                              parity_ok=bool(g.parity_ok[0]))
