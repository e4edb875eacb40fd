"""The matching semantics of the SiM chip, defined once (host side, numpy).

This is the *specification* the host chip model and the CUDA kernels
implement: a masked 64-bit equality test per 8-byte slot.

    match[s] = (((slot_lo[s] ^ q_lo) & m_lo) | ((slot_hi[s] ^ q_hi) & m_hi)) == 0

A set mask bit means "compare this bit position"; cleared bits are
"don't care" (paper §III-B).  The all-zero mask therefore matches *every*
slot — the degenerate full-page select used by redistribution (§V-D).

Only numpy: PyTorch on the CPU lacks most uint32 operations and PyTorch on
CUDA has no int64 matmul for the one-hot gather, so the device versions of
these functions are the kernels' plain versions (``kernels/*/ref.py``).
"""
from __future__ import annotations

import numpy as np

from .bits import chunk_bitmap_from_slot_bitmap, pack_bitmap, unpack_bitmap


def match_slots(slot_words, query_pair, mask_pair):
    """(..., S, 2) uint32 x (2,) x (2,) -> (..., S) uint32 {0,1} match bits."""
    w = np.asarray(slot_words, dtype=np.uint32)
    q = np.asarray(query_pair, dtype=np.uint32)
    m = np.asarray(mask_pair, dtype=np.uint32)
    mismatch = ((w[..., 0] ^ q[..., 0]) & m[..., 0]) | (
        (w[..., 1] ^ q[..., 1]) & m[..., 1])
    return (mismatch == 0).astype(np.uint32)


def search_page(slot_words, query_pair, mask_pair):
    """Full search command semantics: packed (..., 16) uint32 slot bitmap."""
    return pack_bitmap(match_slots(slot_words, query_pair, mask_pair))


def search_to_chunk_bitmap(slot_words, query_pair, mask_pair):
    """search + slot->chunk reduction: (..., 2) uint32 chunk-select bitmap."""
    return chunk_bitmap_from_slot_bitmap(
        search_page(slot_words, query_pair, mask_pair))


def gather_chunks(page_chunks, chunk_bitmap_words, max_out: int):
    """Gather command semantics (order-preserving compaction).

    page_chunks: (64, CB) chunk-major page content (any dtype)
    chunk_bitmap_words: (2,) uint32 chunk-select bitmap
    Returns (out, count): out (max_out, CB) with selected chunks packed to the
    front (tail zero-filled), count = number selected.
    """
    page_chunks = np.asarray(page_chunks)
    bits = unpack_bitmap(np.asarray(chunk_bitmap_words, dtype=np.uint32),
                         n_bits=page_chunks.shape[0])
    positions = np.cumsum(bits) - bits          # output slot for each chunk
    onehot = (
        (positions[None, :] == np.arange(max_out)[:, None]) & (bits[None, :] == 1)
    ).astype(page_chunks.dtype)                 # (max_out, 64)
    out = onehot @ page_chunks                  # one-hot gather
    count = bits.sum().astype(np.int32)
    return out, count
