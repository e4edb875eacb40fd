"""Bit-level helpers for the host (numpy) side of the port.

The SiM data unit is a 64-bit slot, carried as a pair of little-endian
``uint32`` words ``(lo, hi)``; helpers here convert between Python ints,
word pairs, byte views and packed bitmaps.  The device side keeps the same
words as ``torch.int32`` bit patterns (see ``repro_torch.kernels``).
"""
from __future__ import annotations

import numpy as np

U32_MASK = 0xFFFFFFFF
U64_MASK = 0xFFFFFFFFFFFFFFFF

# Slot / page geometry (paper §III-A: 4 KiB page = 512 slots of 8 B; 8 slots
# = one 64 B chunk; 64 chunks per page).
SLOT_BYTES = 8
SLOTS_PER_PAGE = 512
SLOTS_PER_CHUNK = 8
CHUNKS_PER_PAGE = SLOTS_PER_PAGE // SLOTS_PER_CHUNK  # 64
CHUNK_BYTES = SLOT_BYTES * SLOTS_PER_CHUNK           # 64
PAGE_BYTES = SLOT_BYTES * SLOTS_PER_PAGE             # 4096
BITMAP_WORDS = SLOTS_PER_PAGE // 32                  # 16 x uint32 = 64 B


def u64_to_pair(value: int) -> tuple[int, int]:
    """Split a Python int (treated as uint64) into (lo, hi) uint32 ints."""
    value &= U64_MASK
    return value & U32_MASK, (value >> 32) & U32_MASK


def pair_to_u64(lo: int, hi: int) -> int:
    return ((int(hi) & U32_MASK) << 32) | (int(lo) & U32_MASK)


def u64_array_to_pairs(values: np.ndarray) -> np.ndarray:
    """(N,) uint64 -> (N, 2) uint32 little-endian word pairs."""
    v = np.asarray(values, dtype=np.uint64)
    return v.view(np.uint32).reshape(*v.shape, 2)


def pairs_to_u64_array(pairs: np.ndarray) -> np.ndarray:
    p = np.ascontiguousarray(pairs, dtype=np.uint32)
    return p.view(np.uint64).reshape(p.shape[:-1])


def bytes_to_slot_words(page_bytes: np.ndarray) -> np.ndarray:
    """(..., 4096) uint8 -> (..., 512, 2) uint32 slot word pairs (LE)."""
    b = np.ascontiguousarray(page_bytes, dtype=np.uint8)
    assert b.shape[-1] % SLOT_BYTES == 0
    n_slots = b.shape[-1] // SLOT_BYTES
    return b.view('<u4').reshape(*b.shape[:-1], n_slots, 2)


def slot_words_to_bytes(words: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(words, dtype=np.uint32)
    return w.view(np.uint8).reshape(*w.shape[:-2], w.shape[-2] * SLOT_BYTES)


# ---------------------------------------------------------------------------
# 32-bit mixers (murmur3 fmix32 and a two-round xorshift-mult) used for the
# per-chunk data randomization streams (paper §IV-C1).  The CUDA kernels
# (kernels/csrc/sim_common.cuh) and the plain PyTorch versions
# (kernels/sim_search/ref.py) compute the same uint32 arithmetic.
# ---------------------------------------------------------------------------

def fmix32(x):
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return x


def mix2_32(x, salt):
    """Two fmix rounds with a salt between them; decorrelates lo/hi streams."""
    return fmix32(fmix32(x) ^ np.uint32(salt))


# ---------------------------------------------------------------------------
# Bitmap packing: (..., 512) {0,1} -> (..., 16) uint32.  Bit i of word w is
# slot 32*w + i (little-endian within word), matching the byte order the chip
# would put on the bus.
# ---------------------------------------------------------------------------

def pack_bitmap(bits):
    bits = np.asarray(bits)
    n = bits.shape[-1]
    assert n % 32 == 0, n
    b = bits.astype(np.uint32).reshape(*bits.shape[:-1], n // 32, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts).sum(axis=-1).astype(np.uint32)


def unpack_bitmap(words, n_bits: int | None = None):
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * 32)
    if n_bits is not None:
        bits = bits[..., :n_bits]
    return bits.astype(np.uint32)


def popcount_words(words: np.ndarray) -> np.ndarray:
    """Population count over trailing word axis -> int32 counts."""
    return unpack_bitmap(words).sum(axis=-1).astype(np.int32)


def chunk_bitmap_from_slot_bitmap(slot_words):
    """Reduce a 512-bit slot bitmap to a 64-bit chunk-select bitmap (2 words).

    A chunk is selected when any of its 8 slots matched — this is what feeds
    the gather command after a search (paper §III-B).
    """
    bits = unpack_bitmap(slot_words)                           # (..., 512)
    s = bits.reshape(*bits.shape[:-1], CHUNKS_PER_PAGE, SLOTS_PER_CHUNK)
    chunk_bits = (s.sum(axis=-1) > 0).astype(np.uint32)        # (..., 64)
    return pack_bitmap(chunk_bits)                             # (..., 2)
