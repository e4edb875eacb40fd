"""OS page-cache model: LRU with dirty tracking and write absorption.

The experiments stress exactly the behaviours the paper leans on (§VII):
  * read-inserted *clean* pages compete with write-buffered *dirty* pages;
  * evicting a dirty page costs a flash program (write-back) — the latency
    chain behind the baseline's write-heavy collapse;
  * repeated writes to a cached dirty page are absorbed (coalescing) — the
    effect SiM amplifies by bypassing the cache for reads (§VII-A).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    absorbed_writes: int = 0
    clean_evictions: int = 0
    dirty_evictions: int = 0
    inserts: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PageCache:
    """LRU page cache; capacity 0 disables caching entirely.

    ``max_dirty_fraction`` models Linux's vm.dirty_ratio writer throttling:
    once dirty pages exceed the fraction, inserting another dirty page first
    forces write-back of the least-recently-used dirty page.  The CPU-centric
    baseline runs with the kernel default (~0.2); SiM's application-managed
    write buffer is unconstrained (1.0) — this asymmetry, together with read
    bypass, is exactly the "frees the cache for write buffering" effect the
    paper's write-heavy speedups rest on (§VII-A).
    """

    def __init__(self, capacity_pages: int, max_dirty_fraction: float = 1.0):
        self.capacity = int(capacity_pages)
        self.max_dirty = max(1, int(capacity_pages * max_dirty_fraction)) \
            if capacity_pages else 0
        self._lru: OrderedDict[int, bool] = OrderedDict()   # page -> dirty
        self._dirty_count = 0
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, page: int) -> bool:
        return page in self._lru

    @property
    def dirty_count(self) -> int:
        return self._dirty_count

    def lookup(self, page: int) -> bool:
        """Read probe; refreshes recency on hit."""
        if self.capacity and page in self._lru:
            self._lru.move_to_end(page)
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        return False

    def _pop_lru(self, dirty_only: bool) -> tuple[int, bool] | None:
        if dirty_only:
            for p, d in self._lru.items():          # LRU order
                if d:
                    del self._lru[p]
                    self._dirty_count -= 1
                    self.stats.dirty_evictions += 1
                    return (p, True)
            return None
        victim, was_dirty = self._lru.popitem(last=False)
        if was_dirty:
            self._dirty_count -= 1
            self.stats.dirty_evictions += 1
        else:
            self.stats.clean_evictions += 1
        return (victim, was_dirty)

    def insert(self, page: int, dirty: bool) -> list[tuple[int, bool]]:
        """Insert/update a page; returns evicted [(page, was_dirty), ...].

        Writing a page that is already resident marks it dirty and counts as
        an absorbed write (no flash I/O now or later for the overwritten
        version).  Dirty inserts above the dirty budget force write-back of
        the LRU dirty page (writer throttling).
        """
        if self.capacity == 0:
            return []
        evicted: list[tuple[int, bool]] = []
        if page in self._lru:
            was = self._lru[page]
            if dirty and was:
                self.stats.absorbed_writes += 1
            if dirty and not was:
                if self._dirty_count >= self.max_dirty:
                    ev = self._pop_lru(dirty_only=True)
                    if ev:
                        evicted.append(ev)
                self._dirty_count += 1
            self._lru[page] = was or dirty
            self._lru.move_to_end(page)
            return evicted
        self.stats.inserts += 1
        if dirty and self._dirty_count >= self.max_dirty:
            ev = self._pop_lru(dirty_only=True)
            if ev:
                evicted.append(ev)
        if len(self._lru) >= self.capacity:
            ev = self._pop_lru(dirty_only=False)
            if ev:
                evicted.append(ev)
        self._lru[page] = dirty
        if dirty:
            self._dirty_count += 1
        return evicted

    def flush_all(self) -> list[int]:
        """Drop everything; returns dirty pages that need write-back."""
        dirty = [p for p, d in self._lru.items() if d]
        self._lru.clear()
        self._dirty_count = 0
        return dirty
