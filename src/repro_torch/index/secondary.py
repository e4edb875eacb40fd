"""Secondary index with BitWeaving-encoded rows on SiM pages (§V-B/C).

Rows are packed into 8-byte keys by a RowCodec (column -> bit range).  A
column predicate becomes one masked search per page (point) or the §V-C
range plan (range); gather returns only the matching encoded rows, from
which the host decodes e.g. the user id.

Predicates execute through a MatchBackend: every page's plan command is
enqueued and flushed together, so a table scan is one ``sim_plan`` launch
(and one follow-up ``sim_gather`` launch) on the batched backend instead of
a per-page command loop.  Range predicates ride ``Op.PLAN`` — the multi-pass §V-C
decomposition accumulates OR/AND-NOT in-latch (Fig 10) and only the
combined 64 B bitmap per page crosses the bus, independent of pass count.
"""
from __future__ import annotations

import numpy as np

from repro_torch.backend import MatchBackend, as_backend
from repro_torch.core.bits import (SLOTS_PER_CHUNK, chunk_bitmap_from_slot_bitmap,
                             pair_to_u64, unpack_bitmap)
from repro_torch.core.bitweaving import RowCodec
from repro_torch.core.commands import Command
from repro_torch.core.page import mask_header_slots
from repro_torch.core.range_query import RangePlan, evaluate_plan_on_pages
from repro_torch.reliability import require_clean

ROWS_PER_PAGE = 504


class SimSecondaryIndex:
    def __init__(self, backend, codec: RowCodec, *, first_page: int = 0):
        self.backend: MatchBackend = as_backend(backend)
        self.codec = codec
        self.first_page = first_page
        self.n_pages = 0
        self.n_rows = 0
        self.io_bitmap_bytes = 0
        self.io_chunk_bytes = 0

    @property
    def chips(self):
        return self.backend.chips

    def load_rows(self, rows: dict[str, np.ndarray]) -> None:
        keys = self.codec.encode_rows(rows)
        self.n_rows = len(keys)
        self._rows_in_page: list[int] = []
        for start in range(0, len(keys), ROWS_PER_PAGE):
            page = self.first_page + self.n_pages
            chunk = keys[start:start + ROWS_PER_PAGE]
            self.backend.program_entries(page, chunk)
            self._rows_in_page.append(len(chunk))
            self.n_pages += 1

    # ---------------------------------------------------------- predicates
    def _page_addrs(self) -> list[int]:
        return [self.first_page + p for p in range(self.n_pages)]

    def _collect_pages(self, bitmaps: np.ndarray) -> np.ndarray:
        """Gather matching rows of all pages -> decoded uint64 keys.

        Slots past a page's row count are vacant (all-ones sentinel) and
        can alias masked predicates (e.g. any column test with all-set
        bits), so the host strips them — the same software-side
        responsibility as the header-chunk mask.  All gathers are enqueued
        before one flush.
        """
        pending = []                       # (slots, ticket)
        for p, bitmap_words in enumerate(bitmaps):
            page = self.first_page + p
            bitmap = mask_header_slots(bitmap_words)
            slots = np.nonzero(unpack_bitmap(bitmap, 512))[0]
            slots = slots[slots < SLOTS_PER_CHUNK + self._rows_in_page[p]]
            if slots.size == 0:
                continue
            cb = int(pair_to_u64(*chunk_bitmap_from_slot_bitmap(bitmap)))
            pending.append((slots, self.backend.submit_gather(
                Command.gather(page, cb))))
        self.backend.flush()

        rows = []
        for slots, ticket in pending:
            g = require_clean(ticket.result())
            self.io_chunk_bytes += 64 * len(g.chunk_ids)
            chunk_pos = {int(c): j for j, c in enumerate(g.chunk_ids)}
            out = np.zeros(slots.size, dtype=np.uint64)
            for i, s in enumerate(slots):
                c, off = int(s) // SLOTS_PER_CHUNK, \
                    (int(s) % SLOTS_PER_CHUNK) * 8
                out[i] = int.from_bytes(
                    bytes(g.chunks[chunk_pos[c]][off:off + 8]), "little")
            rows.append(out)
        return (np.concatenate(rows) if rows
                else np.zeros(0, dtype=np.uint64))

    def select_equals(self, column: str, value: int) -> np.ndarray:
        """Fig 9: e.g. all rows with gender == female -> encoded rows."""
        mq = self.codec.equals(column, value)
        plan = RangePlan(include=(mq,))
        bitmaps = evaluate_plan_on_pages(self.backend, plan,
                                         self._page_addrs())
        self.io_bitmap_bytes += 64 * self.n_pages
        return self._collect_pages(bitmaps)

    def select_range(self, column: str, lo: int, hi: int, *,
                     exact: bool = True) -> np.ndarray:
        """Fig 10: lo <= column < hi via the masked-equality range plan.

        The whole predicate is ONE ``Op.PLAN`` per page: all passes
        accumulate in-latch and 64 B per page crosses the bus, no matter
        how many passes the decomposition needs.  With ``exact=False``
        the one-pass-per-bound approximate plan is used and the
        (superset) result is refined on the host — the workflow the
        paper proposes for analytical scans.
        """
        plan: RangePlan = self.codec.range(column, lo, hi, exact=exact)
        bitmaps = evaluate_plan_on_pages(self.backend, plan,
                                         self._page_addrs())
        self.io_bitmap_bytes += 64 * self.n_pages   # combined, pass-free
        got = self._collect_pages(bitmaps)
        if not exact and got.size:
            vals = self.codec.decode_rows(got, column)
            got = got[(vals >= lo) & (vals < hi)]   # host-side refinement
        return got
