"""Per-chunk data randomization (paper §IV-C1), host side.

Modern SSDs XOR stored data with a deterministic pseudo-random stream so the
cell charge distribution stays balanced.  SiM's twist: the stream seed is
derived from the *chunk* address (not the page), so non-contiguous chunks can
be de-randomized independently by the gather command, and the *query key* is
randomized in the deserializer with the same stream — the stream then cancels
out inside the XOR match and matching runs directly on randomized data.

The stream is a counter-based PRNG (two decorrelated fmix32 lanes per slot
word).  The search and lookup kernels regenerate the same stream on the card
(kernels/csrc/sim_common.cuh); this module is the host's copy.
"""
from __future__ import annotations

import numpy as np

from .bits import CHUNKS_PER_PAGE, SLOTS_PER_CHUNK, SLOTS_PER_PAGE, mix2_32

_LO_SALT = 0x9E3779B9
_HI_SALT = 0x7F4A7C15


def stream_words(page_addr, device_seed: int = 0):
    """Randomization stream for one page: (512, 2) uint32.

    The counter for slot ``s`` of chunk ``c`` of page ``p`` is the global slot
    address ``(p*64 + c)*8 + s`` mixed with a device seed.  Chunk-addressed
    seeding means a chunk's stream never depends on its page offset.
    """
    page_addr = int(page_addr)
    chunk_base = np.uint32((page_addr * CHUNKS_PER_PAGE) & 0xFFFFFFFF)
    slot_idx = np.arange(SLOTS_PER_PAGE, dtype=np.uint32)
    ctr = (chunk_base * np.uint32(SLOTS_PER_CHUNK) + slot_idx).astype(np.uint32)
    ctr = ctr ^ np.uint32(device_seed & 0xFFFFFFFF)
    return np.stack([mix2_32(ctr, _LO_SALT), mix2_32(ctr, _HI_SALT)], axis=-1)


def chunk_stream_words(page_addr: int, chunk_idx: int, device_seed: int = 0):
    """Stream for a single chunk: (8, 2) uint32 — used by gather-side
    de-randomization of non-contiguous chunks."""
    return chunk_stream_words_batch([page_addr], [chunk_idx], device_seed)[0]


def chunk_stream_words_batch(page_addrs, chunk_ids, device_seeds):
    """Streams for K (page, chunk, seed) triples at once: (K, 8, 2) uint32.

    One call de-randomizes every chunk of a whole gather/lookup burst (the
    host tail of the batched backend's flush).  ``device_seeds`` may be a
    scalar (one chip) or a (K,) array (burst spanning chips).
    """
    pages = np.asarray(page_addrs, dtype=np.int64).astype(np.uint32)
    chunks = np.asarray(chunk_ids, dtype=np.int64).astype(np.uint32)
    seeds = np.broadcast_to(
        (np.asarray(device_seeds, dtype=np.int64) & 0xFFFFFFFF
         ).astype(np.uint32), pages.shape)
    chunk_addr = (pages * np.uint32(CHUNKS_PER_PAGE) + chunks).astype(
        np.uint32)
    slot_idx = np.arange(SLOTS_PER_CHUNK, dtype=np.uint32)
    ctr = (chunk_addr[:, None] * np.uint32(SLOTS_PER_CHUNK)
           + slot_idx[None, :]).astype(np.uint32)
    ctr = ctr ^ seeds[:, None]
    return np.stack([mix2_32(ctr, _LO_SALT), mix2_32(ctr, _HI_SALT)], axis=-1)


def randomize_page_words(words, page_addr, device_seed: int = 0):
    """XOR a page of (512, 2) slot words with its stream (involution)."""
    return np.asarray(words, dtype=np.uint32) ^ stream_words(page_addr,
                                                             device_seed)


def randomize_query(query_pair, page_addr, device_seed: int = 0):
    """Randomize an 8-byte query against every slot position of a page.

    Returns (512, 2) uint32: the per-slot randomized query the deserializer
    broadcasts down the bitlines.  XORing this with the randomized page data
    equals XORing the plain query with plain data — the cancellation property
    the whole scheme rests on.
    """
    q = np.asarray(query_pair, dtype=np.uint32)
    return q[None, :] ^ stream_words(page_addr, device_seed)
