"""Extendible hash index with SiM bucket pages (paper §V, Fig 11).

The in-memory directory maps hash prefixes to bucket pages.  A bucket stores
packed (key -> value) entries as two SiM pages.  Bucket splits use the §V-D
keyspace-partitioning trick: one masked *search* per half isolates the
entries whose next hash bit is 0/1, and *gather* moves only those chunks —
no full-page read during redistribution.

Device traffic flows through a MatchBackend; ``lookup_batch`` enqueues a
burst of probes and flushes once (one kernel launch per phase on the
batched backend: one ``sim_search``, then one ``sim_gather`` if any probe
hit).  Bucket pages are allocated sequentially, so the chip array routes
them round-robin over its chips.

Write path.  Inserts do NOT reprogram the bucket's two pages per call
anymore — bucket mutations land in host-mirror arrays with amortized
(doubling) growth and the dirty pages sit in a coalescing ``WriteBuffer``
(repro_torch.buffer): consecutive inserts into one bucket collapse to ONE
deferred ``submit_program`` per page at the next flush point (a lookup, a
split, or an explicit ``flush_writes()``), which the batched backend stages
as one grouped plane-store update.  A split reads the bucket's key page on
the device, so it drains the buffer first: the reprogram restages the row
before the split's search launches, in the arena's one stream.  Lookups flush first, so read-your-
writes and the lookup parity tests hold unchanged.

Splits are *iterative*: a full bucket splits until the target fits, and a
degenerate split — every key on one side because the keys share a hash
prefix — no longer recurses without bound.  ``depth_cap`` bounds the local
depth (and with it the directory, which doubles per global split); a
bucket that is still full at the cap overflows in place instead, bounded
by the page's 504 user slots.
"""
from __future__ import annotations

import numpy as np

from repro_torch.backend import MatchBackend, as_backend
from repro_torch.buffer.writebuffer import WriteBuffer
from repro_torch.core.bits import (SLOTS_PER_CHUNK, chunk_bitmap_from_slot_bitmap,
                             pair_to_u64, unpack_bitmap)
from repro_torch.core.commands import Command
from repro_torch.core.page import USER_SLOTS, mask_header_slots
from repro_torch.reliability import require_clean

FULL_MASK = 0xFFFFFFFFFFFFFFFF
BUCKET_CAPACITY = 404
DEPTH_CAP = 20     # bounds degenerate split chains AND the directory (2^cap)


def _hash64(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — uniform bucket spread for arbitrary keys."""
    z = np.asarray(keys, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class Bucket:
    """Host mirror of one bucket's two pages, with amortized append.

    Entries live in capacity arrays that double on demand — an insert is
    O(1) amortized instead of the O(n) ``np.append`` reallocation per call
    the old dataclass paid twice per insert.  ``keys``/``values`` expose
    zero-copy views of the live prefix.
    """

    __slots__ = ("key_page", "value_page", "local_depth", "n",
                 "_keys", "_vals")

    def __init__(self, key_page: int, value_page: int, local_depth: int,
                 capacity: int = 64):
        self.key_page = key_page
        self.value_page = value_page
        self.local_depth = local_depth
        self.n = 0
        self._keys = np.empty(capacity, dtype=np.uint64)
        self._vals = np.empty(capacity, dtype=np.uint64)

    @property
    def keys(self) -> np.ndarray:
        return self._keys[:self.n]

    @property
    def values(self) -> np.ndarray:
        return self._vals[:self.n]

    def _grow_to(self, need: int) -> None:
        if need <= self._keys.size:
            return
        cap = max(self._keys.size * 2, need)
        self._keys = np.resize(self._keys, cap)
        self._vals = np.resize(self._vals, cap)

    def append(self, key: int, value: int) -> None:
        self._grow_to(self.n + 1)
        self._keys[self.n] = key
        self._vals[self.n] = value
        self.n += 1

    def set_entries(self, keys: np.ndarray, values: np.ndarray) -> None:
        self._grow_to(keys.size)
        self._keys[:keys.size] = keys
        self._vals[:values.size] = values
        self.n = int(keys.size)


class SimHashIndex:
    def __init__(self, backend, *, global_depth: int = 2,
                 depth_cap: int = DEPTH_CAP, write_high_water: int = 16):
        if not (0 < depth_cap <= 63):
            raise ValueError(f"depth_cap must be in (0, 63], got {depth_cap}")
        self.backend: MatchBackend = as_backend(backend)
        self.global_depth = global_depth
        self.depth_cap = max(depth_cap, global_depth)
        self.write_buffer = WriteBuffer(high_water=write_high_water)
        self._next_page = 0
        self.buckets: list[Bucket] = []
        self.directory: list[int] = []
        for _ in range(1 << global_depth):
            self.directory.append(self._new_bucket(global_depth))
        self.splits = 0
        self.split_searches = 0
        self.split_gathered_chunks = 0

    @property
    def chips(self):
        return self.backend.chips

    def _new_bucket(self, depth: int) -> int:
        kp, vp = self._next_page, self._next_page + 1
        self._next_page += 2
        self.buckets.append(Bucket(kp, vp, depth))
        # Structural page allocation is eager (pages must exist before any
        # device command routes to them); data updates go through the
        # write buffer.
        self.backend.program_entries(kp, np.zeros(0, dtype=np.uint64))
        self.backend.program_entries(vp, np.zeros(0, dtype=np.uint64))
        return len(self.buckets) - 1

    def _dir_slot(self, key: int) -> int:
        h = int(_hash64(np.array([key], dtype=np.uint64))[0])
        return h & ((1 << self.global_depth) - 1)

    # ----------------------------------------------------------- write path
    def _put_bucket(self, b: Bucket) -> None:
        """Mark both of the bucket's pages dirty in the coalescing buffer;
        consecutive inserts into one bucket collapse to one program per
        page at the next flush point."""
        self.write_buffer.put(b.key_page, b.keys)
        self.write_buffer.put(b.value_page, b.values)
        if self.write_buffer.should_flush:
            self.flush_writes()

    def flush_writes(self) -> int:
        """Drain dirty bucket pages as one deferred-program group."""
        return self.write_buffer.flush(self.backend)

    # -------------------------------------------------------------- insert
    def insert(self, key: int, value: int) -> None:
        bi = self.directory[self._dir_slot(key)]
        b = self.buckets[bi]
        # Iterative split-until-fits: a degenerate split (every key on one
        # side) just deepens the bucket, so the loop terminates at
        # depth_cap instead of recursing without bound.  At the cap the
        # bucket overflows in place (bounded by the page's user slots).
        while b.n >= BUCKET_CAPACITY and b.local_depth < self.depth_cap:
            self._split(bi)
            bi = self.directory[self._dir_slot(key)]
            b = self.buckets[bi]
        hit = np.nonzero(b.keys == np.uint64(key))[0]
        if hit.size:                   # updates need no new slot, so they
            b._vals[hit[0]] = value    # succeed even at a full capped bucket
        elif b.n >= USER_SLOTS:
            raise RuntimeError(
                f"bucket at depth cap {self.depth_cap} overflowed the page "
                f"({b.n} entries): degenerate key set")
        else:
            b.append(key, value)
        self._put_bucket(b)

    def _split(self, bi: int) -> None:
        """§V-D redistribution: partition the bucket by the next hash bit
        using one masked search per side + chunk gathers (demonstrated with
        real SiM commands on the key page; the host mirror does bookkeeping).
        """
        # The on-device demonstration reads the bucket's key page, so the
        # buffered image must be programmed first.
        self.flush_writes()
        b = self.buckets[bi]
        self.splits += 1
        bit = b.local_depth
        h = _hash64(b.keys)
        side1 = ((h >> np.uint64(bit)) & np.uint64(1)).astype(bool)

        # Demonstrate the command sequence on-device: search key page with a
        # mask selecting nothing of the key (mask=0 matches all), then use
        # host-computed partition bitmaps to gather each side's chunks.
        resp = require_clean(self.backend.search(
            Command.search(b.key_page, 0, 0)))
        self.split_searches += 1
        bitmap = mask_header_slots(resp.bitmap_words)
        cb = int(pair_to_u64(*chunk_bitmap_from_slot_bitmap(bitmap)))
        g = self.backend.gather(Command.gather(b.key_page, cb))
        self.split_gathered_chunks += len(g.chunk_ids)

        if b.local_depth == self.global_depth:
            # dir slots use the LOW hash bits: growing the depth appends a
            # high bit, so the doubled directory is two concatenated copies.
            self.directory = self.directory + self.directory
            self.global_depth += 1
        new_bi = self._new_bucket(b.local_depth + 1)
        nb = self.buckets[new_bi]
        keys, vals = b.keys.copy(), b.values.copy()
        nb.set_entries(keys[side1], vals[side1])
        b.set_entries(keys[~side1], vals[~side1])
        b.local_depth += 1
        for d in range(len(self.directory)):
            if self.directory[d] == bi and ((d >> bit) & 1):
                self.directory[d] = new_bi
        for bb in (b, nb):
            self.write_buffer.put(bb.key_page, bb.keys)
            self.write_buffer.put(bb.value_page, bb.values)

    # -------------------------------------------------------------- lookup
    def lookup(self, key: int) -> int | None:
        return self.lookup_batch([key])[0]

    def lookup_batch(self, keys) -> list[int | None]:
        """Batched probes: all bucket searches flush as one launch, then
        all value-page gathers as a second.  Dirty buffered pages program
        first (read-your-writes)."""
        self.flush_writes()
        buckets = [self.buckets[self.directory[self._dir_slot(int(k))]]
                   for k in keys]
        tickets = [self.backend.submit_search(
            Command.search(b.key_page, int(k), FULL_MASK))
            for k, b in zip(keys, buckets)]
        self.backend.flush()

        slots_out: list[int | None] = []
        gathers = []
        for b, t in zip(buckets, tickets):
            bitmap = mask_header_slots(require_clean(t.result()).bitmap_words)
            slots = np.nonzero(unpack_bitmap(bitmap, 512))[0]
            if slots.size == 0:
                slots_out.append(None)
                gathers.append(None)
                continue
            entry = int(slots[0]) - SLOTS_PER_CHUNK
            value_slot = SLOTS_PER_CHUNK + entry
            slots_out.append(value_slot)
            gathers.append(self.backend.submit_gather(Command.gather(
                b.value_page, 1 << (value_slot // SLOTS_PER_CHUNK))))
        self.backend.flush()

        out: list[int | None] = []
        for value_slot, g in zip(slots_out, gathers):
            if g is None:
                out.append(None)
                continue
            off = (value_slot % SLOTS_PER_CHUNK) * 8
            out.append(int.from_bytes(
                bytes(require_clean(g.result()).chunks[0][off:off + 8]),
                "little"))
        return out
