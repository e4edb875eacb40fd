"""B+Tree primary index with SiM leaf pages (paper §V-A, Fig 8).

Internal nodes live in host memory (sorted separator arrays); leaf nodes are
pairs of SiM pages — a key page and a value page on different chips/dies —
searched with `search` and fetched with `gather`.  A lookup therefore ships
one 8-byte query down and gets 64 B of bitmap + 64 B of chunk back instead
of two 4 KiB pages.

All device traffic flows through a MatchBackend.  Point lookups use the
fused LOOKUP primitive — key-page search, first-slot selection and
value-page chunk gather in one command — so a ``lookup_batch`` burst is a
single ``sim_lookup`` launch on the batched backend.  ``range_query``
enqueues one ``Op.PLAN`` per touched leaf (one ``sim_plan`` launch) and then
every gather (one ``sim_gather`` launch) before flushing, so a whole scan
executes as one batched launch per phase (§IV-E).

The host-side B+Tree logic is deliberately ordinary; everything interesting
happens in how little data crosses the bus.

Page addressing goes through the backend's namespace: the chip array
routes sequentially-allocated leaf pages round-robin over its chips, so a
leaf's key and value page land on *different* chips — the §V-A cross-die
pairing.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from repro_torch.backend import MatchBackend, as_backend
from repro_torch.core.bits import (SLOTS_PER_CHUNK, chunk_bitmap_from_slot_bitmap,
                             pair_to_u64, unpack_bitmap)
from repro_torch.core.commands import Command
from repro_torch.core.page import mask_header_slots
from repro_torch.core.range_query import evaluate_plan_on_pages, exact_range
from repro_torch.reliability import require_clean

FULL_MASK = 0xFFFFFFFFFFFFFFFF
LEAF_CAPACITY = 504


@dataclasses.dataclass
class Leaf:
    key_page: int
    value_page: int
    n_entries: int
    low_key: int         # smallest key (separator)


@dataclasses.dataclass
class LookupStats:
    searches: int = 0
    gathers: int = 0
    bitmap_bytes: int = 0
    chunk_bytes: int = 0


class SimBTree:
    """Bulk-loaded B+Tree over (uint64 key -> uint64 value).

    ``backend`` accepts either a MatchBackend or a raw SimChipArray (which
    is adapted to the scalar reference backend).
    """

    def __init__(self, backend, *, leaf_fill: int = 404):
        self.backend: MatchBackend = as_backend(backend)
        self.leaf_fill = min(leaf_fill, LEAF_CAPACITY)
        self.leaves: list[Leaf] = []
        self._separators: list[int] = []     # low key of each leaf
        self._next_page = 0
        self.stats = LookupStats()

    @property
    def chips(self):
        return self.backend.chips

    # ------------------------------------------------------------- loading
    def bulk_load(self, keys: np.ndarray, values: np.ndarray,
                  timestamp_ns: int = 0) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        order = np.argsort(keys, kind="stable")
        keys, values = keys[order], values[order]
        if keys.size and np.any(keys[:-1] == keys[1:]):
            raise ValueError("duplicate keys in primary index")
        for start in range(0, len(keys), self.leaf_fill):
            k = keys[start:start + self.leaf_fill]
            v = values[start:start + self.leaf_fill]
            kp, vp = self._next_page, self._next_page + 1
            self._next_page += 2
            self.backend.program_entries(kp, k, timestamp_ns=timestamp_ns)
            self.backend.program_entries(vp, v, timestamp_ns=timestamp_ns)
            self.leaves.append(Leaf(kp, vp, len(k), int(k[0])))
            self._separators.append(int(k[0]))

    # -------------------------------------------------------------- lookup
    def _leaf_for(self, key: int) -> Leaf | None:
        i = bisect.bisect_right(self._separators, int(key)) - 1
        return self.leaves[i] if i >= 0 else None

    def lookup(self, key: int) -> int | None:
        """Point query: fused search+gather on the leaf's paired pages
        (pipelined on-chip, §III-B — one command, one launch)."""
        return self.lookup_batch([key])[0]

    def lookup_batch(self, keys) -> list[int | None]:
        """Batched point queries through ``submit_lookup``: the whole burst
        is ONE ``sim_lookup`` launch on the batched backend — the key-page
        match, the first-slot selection and the value-page chunk gather
        never leave the device.  Keys below the first separator submit nothing, so a
        burst of only such keys launches nothing."""
        leaves = [self._leaf_for(int(k)) for k in keys]
        tickets = []
        for k, leaf in zip(keys, leaves):
            if leaf is None:
                tickets.append(None)
                continue
            tickets.append(self.backend.submit_lookup(
                Command.lookup(leaf.key_page, leaf.value_page, int(k),
                               FULL_MASK)))
            self.stats.searches += 1
            self.stats.bitmap_bytes += 64
        self.backend.flush()

        out: list[int | None] = []
        for t in tickets:
            if t is None:
                out.append(None)
                continue
            resp = require_clean(t.result())
            if resp.value_slot is None:
                out.append(None)
                continue
            self.stats.gathers += 1
            self.stats.chunk_bytes += 64
            out.append(int.from_bytes(resp.value, "little"))
        return out

    # --------------------------------------------------------------- range
    def range_query(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """lo <= key < hi via the §V-C masked-equality decomposition: one
        ``Op.PLAN`` per touched leaf flushes as one batch (the passes
        accumulate in-latch, 64 B/leaf on the bus), then all key/value-page
        gathers flush as a second batch."""
        plan = exact_range(int(lo), int(hi), width=64)
        i0 = max(bisect.bisect_right(self._separators, int(lo)) - 1, 0)
        leaves = [leaf for leaf in self.leaves[i0:] if leaf.low_key < hi]
        if not leaves:
            return []
        bitmaps = evaluate_plan_on_pages(
            self.backend, plan, [leaf.key_page for leaf in leaves])
        self.stats.searches += plan.n_passes * len(leaves)  # on-chip matches
        self.stats.bitmap_bytes += 64 * len(leaves)         # combined bitmaps

        hits = []                      # (leaf, slots, key ticket, val ticket)
        for leaf, acc in zip(leaves, bitmaps):
            acc = mask_header_slots(acc)
            slots = np.nonzero(unpack_bitmap(acc, 512))[0]
            if slots.size == 0:
                continue
            # gather matched key chunks + the aligned value chunks
            kb = int(pair_to_u64(*chunk_bitmap_from_slot_bitmap(acc)))
            gk = self.backend.submit_gather(Command.gather(leaf.key_page, kb))
            gv = self.backend.submit_gather(Command.gather(leaf.value_page,
                                                           kb))
            self.stats.gathers += 2
            hits.append((leaf, slots, gk, gv))
        self.backend.flush()

        out: list[tuple[int, int]] = []
        for _leaf, slots, gk, gv in hits:
            rk, rv = require_clean(gk.result()), require_clean(gv.result())
            self.stats.chunk_bytes += 64 * (len(rk.chunk_ids)
                                            + len(rv.chunk_ids))
            chunk_pos = {int(c): j for j, c in enumerate(rk.chunk_ids)}
            for s in slots:
                c, off = s // SLOTS_PER_CHUNK, (s % SLOTS_PER_CHUNK) * 8
                j = chunk_pos[int(c)]
                k = int.from_bytes(bytes(rk.chunks[j][off:off + 8]), "little")
                v = int.from_bytes(bytes(rv.chunks[j][off:off + 8]), "little")
                out.append((k, v))
        return out
