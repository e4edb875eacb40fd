"""SiM page construction and views (paper §III-A).

A match-mode page is an array of 512 aligned 8-byte slots; eight slots form a
64 B chunk, the minimal transfer unit.  Chunk 0 is the verification header
(see ecc.py).  Key/value index pages place a compact array of 8-byte entries
in chunks 1..63 (504 usable slots).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import spans

from . import ecc
from .bits import (PAGE_BYTES, SLOTS_PER_CHUNK, SLOTS_PER_PAGE,
                   bytes_to_slot_words, slot_words_to_bytes,
                   u64_array_to_pairs)
from .randomize import randomize_page_words

# Slots available for user data when chunk 0 carries the header.
USER_SLOTS = SLOTS_PER_PAGE - SLOTS_PER_CHUNK  # 504
EMPTY_SLOT = 0xFFFFFFFFFFFFFFFF                # all-ones = vacant


@dataclasses.dataclass
class BuiltPage:
    """A page as it exists on flash plus its out-of-band metadata."""
    raw: np.ndarray            # (4096,) uint8 — randomized, as stored
    plain: np.ndarray          # (4096,) uint8 — pre-randomization content
    chunk_parities: np.ndarray  # (64,) uint32 inner-code CRCs (over plain bytes)
    page_addr: int
    timestamp_ns: int
    n_entries: int


def build_page(entries: np.ndarray, page_addr: int, *, timestamp_ns: int = 0,
               header_user: np.ndarray | None = None, device_seed: int = 0,
               randomize: bool = True) -> BuiltPage:
    """Lay out up to 504 uint64 entries into a match-mode page.

    Vacant slots are filled with EMPTY_SLOT so an equality search for a real
    key can never alias a hole (keys are required to differ from it).
    """
    entries = np.asarray(entries, dtype=np.uint64).ravel()
    if entries.size > USER_SLOTS:
        raise ValueError(f"{entries.size} entries > {USER_SLOTS} user slots")
    slots = np.full(USER_SLOTS, EMPTY_SLOT, dtype=np.uint64)
    slots[:entries.size] = entries

    body = slot_words_to_bytes(u64_array_to_pairs(slots))
    s = spans.ON and spans.begin("chip.ecc")
    header = ecc.build_header_chunk(timestamp_ns, header_user)
    plain = np.concatenate([header, body]).astype(np.uint8)
    assert plain.size == PAGE_BYTES

    parities = ecc.build_chunk_parities(plain)
    if s:
        spans.end(s)
    if randomize:
        s = spans.ON and spans.begin("chip.randomize")
        words = bytes_to_slot_words(plain)
        rnd = randomize_page_words(words, page_addr, device_seed)
        raw = slot_words_to_bytes(rnd)
        if s:
            spans.end(s)
    else:
        raw = plain.copy()
    return BuiltPage(raw=raw, plain=plain, chunk_parities=parities,
                     page_addr=page_addr, timestamp_ns=timestamp_ns,
                     n_entries=int(entries.size))


def page_slot_words(page_bytes: np.ndarray) -> np.ndarray:
    """(4096,) uint8 -> (512, 2) uint32 slot view (no copy semantics needed)."""
    return bytes_to_slot_words(np.asarray(page_bytes, dtype=np.uint8))


def entries_from_plain(plain: np.ndarray, n_entries: int) -> np.ndarray:
    """Recover the uint64 entry array from a plain page image."""
    words = bytes_to_slot_words(plain)[SLOTS_PER_CHUNK:]
    from .bits import pairs_to_u64_array
    return pairs_to_u64_array(words)[:n_entries]


def slot_to_chunk(slot_idx: int) -> int:
    return slot_idx // SLOTS_PER_CHUNK


def user_slot_for_entry(entry_idx: int) -> int:
    """Slot index (within the page) of user entry ``entry_idx``."""
    return SLOTS_PER_CHUNK + entry_idx


def mask_header_slots(bitmap_words):
    """Clear bitmap bits of the header chunk (slots 0..7).

    The chip matches *every* slot — it has no notion of a header — so a query
    that happens to equal a header field (e.g. key 0 vs zero-filled metadata
    slots) aliases into chunk 0.  Index software always strips those bits
    before interpreting a search result; this is the software half of the
    paper's RISC-style decomposition.
    """
    out = np.array(bitmap_words, dtype=np.uint32, copy=True)
    out[..., 0] &= np.uint32(0xFFFFFF00)
    return out
