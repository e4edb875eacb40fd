"""Host-side coalescing write buffer (paper §VI: the whole DRAM cache acts
as a write buffer).

The paper's headline write-heavy speedup (Fig 12/13) does not come from
making programs faster — it comes from *not issuing most of them*: SiM
dedicates the SSD's DRAM to buffering updates while searches run in-flash,
so a hot page absorbs many writes and crosses to NAND once per flush
window, and reads of buffered pages are served straight from DRAM
(read-your-writes without touching the die).  TCAM-SSD draws the same
lesson from the command side: in-SSD search pays off only when updates are
batched against the search stream rather than interleaved one-by-one.

``WriteBuffer`` is that DRAM, keyed by page:

  * ``put(page, entries)`` absorbs a write — the full-page entry image is
    copied in; a page already dirty coalesces (last-wins, counted in
    ``stats.coalesced``);
  * ``get(page)`` is the read overlay: reads of a dirty page are served
    from the buffered image (a DRAM hit; counted in ``stats.read_hits``)
    instead of queuing a device command against a stale on-flash image;
  * ``flush(backend)`` drains every dirty page through the backend's
    deferred ``submit_program`` and issues ONE ``backend.flush()`` — the
    batched backend executes the group as one chip-program pass plus one
    grouped plane-store scatter;
  * ``should_flush`` trips at the configurable ``high_water`` dirty-page
    mark, the knob that trades DRAM footprint against program batching.

The buffer holds *entry images*, not raw 4 KiB flash images: randomization,
ECC and page layout happen once, at program time, exactly like the eager
path — so replays through the buffer stay bit-identical to the unbuffered
reference, and to the JAX package's buffered replay
(tests/test_torch_writebuffer.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WriteBufferStats:
    writes: int = 0          # put() calls absorbed into the buffer
    coalesced: int = 0       # puts that overwrote an already-dirty page
    read_hits: int = 0       # overlay reads served from the buffer
    programs: int = 0        # page programs issued across all flushes
    flushes: int = 0         # non-empty flush() calls
    max_dirty: int = 0       # high-water mark actually reached


class WriteBuffer:
    """Coalescing page-image buffer in front of ``MatchBackend`` programs."""

    def __init__(self, *, high_water: int = 16):
        if high_water < 1:
            raise ValueError(f"high_water must be >= 1, got {high_water}")
        self.high_water = high_water
        # page addr -> (entries, kwargs); dict order = first-dirtied order.
        self._dirty: dict[int, tuple[np.ndarray, dict]] = {}
        self.stats = WriteBufferStats()

    # ------------------------------------------------------------- absorb
    def put(self, page_addr: int, entries, **kw) -> None:
        """Absorb a write: buffer the page's full entry image (copied)."""
        page_addr = int(page_addr)
        if page_addr in self._dirty:
            self.stats.coalesced += 1
        self._dirty[page_addr] = (
            np.array(entries, dtype=np.uint64, copy=True), kw)
        self.stats.writes += 1
        self.stats.max_dirty = max(self.stats.max_dirty, len(self._dirty))

    # ------------------------------------------------------------ overlay
    def get(self, page_addr: int) -> np.ndarray | None:
        """Read-your-writes overlay: the buffered entry image of a dirty
        page (newest write wins), or None when the page is clean — clean
        pages are served by the device, whose image is current."""
        entry = self._dirty.get(int(page_addr))
        if entry is None:
            return None
        self.stats.read_hits += 1
        return entry[0]

    @property
    def n_dirty(self) -> int:
        return len(self._dirty)

    @property
    def dirty_pages(self) -> list[int]:
        return list(self._dirty)

    @property
    def should_flush(self) -> bool:
        return len(self._dirty) >= self.high_water

    def would_trip(self, page_addr: int) -> bool:
        """Would ``put(page_addr, ...)`` reach the high-water mark?

        Exact pre-image of ``should_flush`` after the put: a page already
        dirty coalesces (dirty count unchanged), a clean page adds one.
        The JAX package's event frontend uses this to decide whether a
        buffered write absorbs inline into the burst being composed or ends
        it (the drain resolves queued reads first, so it is a burst
        boundary).
        """
        return (len(self._dirty)
                + (int(page_addr) not in self._dirty)) >= self.high_water

    # -------------------------------------------------------------- drain
    def flush(self, backend) -> int:
        """Drain every dirty page as ONE deferred program group.

        Each page goes through ``backend.submit_program`` (already
        coalesced here, so one program per dirty page) and a single
        ``backend.flush()`` executes the group — grouped plane-store
        re-staging included.
        Returns the number of programs issued.
        """
        if not self._dirty:
            return 0
        dirty, self._dirty = self._dirty, {}
        tickets = [backend.submit_program(page_addr, entries, **kw)
                   for page_addr, (entries, kw) in dirty.items()]
        backend.flush()
        # Every program ticket must have resolved in THIS flush:
        # a backend that left one pending would silently defer the page
        # image to some later burst, breaking read-your-writes for readers
        # that bypass the (now clean) overlay.
        unresolved = sum(1 for t in tickets if not t.done)
        if unresolved:
            raise RuntimeError(
                f"backend.flush() left {unresolved}/{len(tickets)} buffered "
                "page programs unresolved")
        self.stats.programs += len(dirty)
        self.stats.flushes += 1
        return len(dirty)
