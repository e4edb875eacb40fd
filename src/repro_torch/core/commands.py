"""The SiM SIMD command ISA (paper §III-B) as host-side datatypes.

These are deliberately dumb — the RISC philosophy of the paper: complex index
operations are decomposed in software into sequences of these four commands.
The engine (engine.py) executes them functionally; the SSD simulator
(flash/ssd.py) executes them in time/energy.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .bits import u64_to_pair


class Op(enum.Enum):
    PAGE_OPEN = "page_open"
    PAGE_CLOSE = "page_close"
    SEARCH = "search"
    GATHER = "gather"
    LOOKUP = "lookup"           # fused search + same-slot value gather
    PLAN = "plan"               # multi-pass range plan, combined in-latch
    READ_FULL = "read_full"     # storage-mode full-page read (baseline path)
    PROGRAM = "program"         # storage-mode page program
    ERASE = "erase"


@dataclasses.dataclass
class Command:
    op: Op
    page_addr: int
    # search operands
    query: tuple[int, int] | None = None    # (lo, hi) uint32 pair
    mask: tuple[int, int] | None = None
    # gather operand: 64-bit chunk-select bitmap as (lo, hi)
    chunk_bitmap: tuple[int, int] | None = None
    # lookup operand: the paired value page whose same-slot chunk is
    # gathered after the key-page search (paper §V-A paired pages)
    value_page: int | None = None
    # plan operands (Op.PLAN): pass rows as ((q_lo, q_hi), (m_lo, m_hi))
    # uint32 pair tuples.  The chip ORs the include passes, AND-NOTs the
    # exclude passes in-latch (paper Fig 10) and transmits ONE combined
    # 64 B bitmap — never the per-pass bitmaps.  Tuples (not lists) so a
    # plan is hashable and backends can dedup identical plans in a burst.
    plan_include: tuple = None
    plan_exclude: tuple = None
    # scheduling metadata
    submit_ns: int = 0
    deadline_ns: int = 0
    tag: int = 0          # caller correlation id

    @staticmethod
    def search(page_addr: int, query_u64: int, mask_u64: int = 0xFFFFFFFFFFFFFFFF,
               **kw) -> "Command":
        return Command(Op.SEARCH, page_addr, query=u64_to_pair(query_u64),
                       mask=u64_to_pair(mask_u64), **kw)

    @staticmethod
    def gather(page_addr: int, chunk_bitmap_u64: int, **kw) -> "Command":
        return Command(Op.GATHER, page_addr,
                       chunk_bitmap=u64_to_pair(chunk_bitmap_u64), **kw)

    @staticmethod
    def lookup(key_page: int, value_page: int, query_u64: int,
               mask_u64: int = 0xFFFFFFFFFFFFFFFF, **kw) -> "Command":
        """Fused point lookup: search ``key_page``, then gather the first
        matching user slot's chunk from the paired ``value_page``."""
        return Command(Op.LOOKUP, key_page, query=u64_to_pair(query_u64),
                       mask=u64_to_pair(mask_u64), value_page=value_page,
                       **kw)

    @staticmethod
    def plan(page_addr: int, include, exclude=(), **kw) -> "Command":
        """Multi-pass range plan (paper Fig 10, §V-C): OR over ``include``
        passes, AND-NOT over ``exclude`` passes, accumulated in the chip's
        latches; one combined bitmap crosses the bus instead of one per
        pass.  Items are ``(query_u64, mask_u64)`` pairs or any object
        with ``query``/``mask`` attributes (``range_query.MaskedQuery``)."""
        def _pairs(items):
            out = []
            for it in items:
                q, mk = (it.query, it.mask) if hasattr(it, "query") else it
                out.append((u64_to_pair(q), u64_to_pair(mk)))
            return tuple(out)
        return Command(Op.PLAN, page_addr, plan_include=_pairs(include),
                       plan_exclude=_pairs(exclude), **kw)

    @property
    def n_passes(self) -> int:
        """Match passes a PLAN command executes on-chip."""
        return len(self.plan_include or ()) + len(self.plan_exclude or ())

    @staticmethod
    def page_open(page_addr: int, **kw) -> "Command":
        return Command(Op.PAGE_OPEN, page_addr, **kw)

    @staticmethod
    def page_close(page_addr: int, **kw) -> "Command":
        return Command(Op.PAGE_CLOSE, page_addr, **kw)

    @staticmethod
    def read_full(page_addr: int, **kw) -> "Command":
        return Command(Op.READ_FULL, page_addr, **kw)

    @staticmethod
    def program(page_addr: int, **kw) -> "Command":
        """Storage-mode page program.  The deferred write path does not
        route entry images through Command objects — see
        ``MatchBackend.submit_program``, which queues (page, entries)
        directly and coalesces last-wins per page."""
        return Command(Op.PROGRAM, page_addr, **kw)


@dataclasses.dataclass
class SearchResponse:
    bitmap_words: np.ndarray        # (16,) uint32 — the 64 B bus payload
    match_count: int
    open_verdict: str               # OpenVerdict.value of the page-open check


@dataclasses.dataclass
class GatherResponse:
    chunks: np.ndarray              # (k, 64) uint8 de-randomized chunk bytes
    chunk_ids: np.ndarray           # (k,) int
    parity_ok: np.ndarray           # (k,) bool inner-code verdicts


@dataclasses.dataclass
class LookupResponse:
    """Result of a fused key-search + value-gather point lookup."""
    search: SearchResponse          # the key-page search, bit-identical to
                                    # an explicit SEARCH command's response
    value_slot: Optional[int]       # first matching user slot, None on miss
    value: Optional[bytes]          # the slot's 8 value bytes, None on miss
    parity_ok: bool = True          # inner-code verdict of the value chunk


@dataclasses.dataclass
class ReadFullResponse:
    plain: np.ndarray               # (4096,) uint8 de-randomized page
