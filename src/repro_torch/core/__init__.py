"""SiM core: the chip substrate, host side (numpy).

Layers:
  bits           — word pairs, mixers, bitmap packing
  match          — the matching specification (numpy)
  page/randomize — on-flash layout and per-chunk randomization
  ecc            — verification header, Optimistic Error Correction,
                   concatenated chunk code
  commands       — the SIMD command ISA
  engine         — functional chip model (latch pipeline, counters)
  range_query    — range -> masked-equality decomposition (approx + exact)
  bitweaving     — column packing for secondary indexes
  scheduler      — deadline-based batch matching
"""
from .bits import (BITMAP_WORDS, CHUNK_BYTES, CHUNKS_PER_PAGE, PAGE_BYTES,
                   SLOT_BYTES, SLOTS_PER_CHUNK, SLOTS_PER_PAGE, pack_bitmap,
                   pair_to_u64, popcount_words, u64_to_pair, unpack_bitmap)
from .bitweaving import Column, RowCodec
from .commands import (Command, GatherResponse, LookupResponse, Op,
                       ReadFullResponse, SearchResponse)
from .ecc import EccConfig, OpenVerdict, optimistic_open
from .engine import SimChip, SimChipArray
from .match import (gather_chunks, match_slots, search_page,
                    search_to_chunk_bitmap)
from .page import EMPTY_SLOT, USER_SLOTS, BuiltPage, build_page
from .range_query import (MaskedQuery, RangePlan, approximate_range,
                          exact_range)
from .scheduler import BatchStats, DeadlineScheduler

__all__ = [
    "BITMAP_WORDS", "CHUNK_BYTES", "CHUNKS_PER_PAGE", "PAGE_BYTES",
    "SLOT_BYTES", "SLOTS_PER_CHUNK", "SLOTS_PER_PAGE", "pack_bitmap",
    "pair_to_u64", "popcount_words", "u64_to_pair", "unpack_bitmap",
    "Column", "RowCodec", "Command", "GatherResponse", "LookupResponse",
    "Op", "ReadFullResponse",
    "SearchResponse", "EccConfig", "OpenVerdict", "optimistic_open",
    "SimChip", "SimChipArray", "gather_chunks", "match_slots",
    "search_page", "search_to_chunk_bitmap", "EMPTY_SLOT", "USER_SLOTS", "BuiltPage",
    "build_page", "MaskedQuery", "RangePlan", "approximate_range",
    "exact_range", "BatchStats", "DeadlineScheduler",
]
