"""Plain PyTorch versions of the two fused search+gather kernels: the
cross-product form (csrc/sim_fused.cu) and the paired lookup
(csrc/sim_lookup.cu).

The two select chunks differently: the cross product gathers every chunk
holding a match, the header chunk (slots 0..7) included; the lookup masks
the header chunk before it picks its first user slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.layout import planes_to_chunk_words
from repro_torch.kernels.sim_gather.ref import compact_chunks
from repro_torch.kernels.sim_search.ref import (pack_bits, select_rows,
                                                stream_planes, to_i32, u32)

NO_SLOT = 512            # first-match sentinel: no user slot matched
SLOTS_PER_CHUNK = 8


def sim_fused_ref(lo, hi, queries, masks, page_ids, page_seeds, *,
                  max_out: int, randomized: bool):
    """Q queries x N pages: search, chunk select, same-page gather.

    lo, hi: (N, 512) int32 planes; queries, masks: (Q, 2) int32;
    page_ids, page_seeds: (N,) int32.  Returns (bitmaps (Q, N, 16) int32,
    gathered (Q, N, max_out, 16) int32 — the chunks holding a match,
    header chunk included, front-packed in chunk order and randomized as
    stored; counts (Q, N) int32 — every selected chunk, those past
    ``max_out`` too).
    """
    d_lo, d_hi = u32(lo), u32(hi)
    if randomized:
        s_lo, s_hi = stream_planes(page_ids, page_seeds)
        d_lo, d_hi = d_lo ^ s_lo, d_hi ^ s_hi
    q, m = u32(queries), u32(masks)
    mm = ((d_lo[None] ^ q[:, 0, None, None]) & m[:, 0, None, None]) | (
        (d_hi[None] ^ q[:, 1, None, None]) & m[:, 1, None, None])
    bits = mm == 0                                     # (Q, N, 512)
    n_q, n = bits.shape[:2]
    chunk_bits = bits.reshape(n_q, n, 64, SLOTS_PER_CHUNK).any(dim=-1)
    shifts = torch.arange(32, dtype=torch.int64, device=lo.device)
    chunk_bitmap = to_i32((chunk_bits.to(torch.int64).reshape(n_q * n, 2, 32)
                           << shifts).sum(dim=-1))     # (Q*N, 2) lo, hi
    chunks = planes_to_chunk_words(lo, hi).expand(n_q, n, 64, 16)
    gathered, counts = compact_chunks(chunks.reshape(n_q * n, 64, 16),
                                      chunk_bitmap, max_out)
    return (pack_bits(bits), gathered.reshape(n_q, n, max_out, 16),
            counts.reshape(n_q, n))


def sim_lookup_ref(klo, khi, vlo, vhi, queries, masks, key_ids, key_seeds, *,
                   randomized: bool, key_rows=None, value_rows=None):
    """Paired lookup: query i vs key row i, value gather from value row i.

    ``key_rows``/``value_rows`` (B,) int32 pick row i of the key and value
    planes (and of ``key_ids``/``key_seeds``); None means row i itself.
    Returns (bitmaps (B, 16) int32 — every match, header slots included;
    value_words (B, 16) int32 — chunk ``min(slot >> 3, 63)`` of value row i,
    randomized as stored, zeros on a miss; slots (B,) int32 — first
    matching user slot (>= 8), 512 if none).
    """
    klo, khi, key_ids, key_seeds = select_rows(key_rows, klo, khi, key_ids,
                                               key_seeds)
    vlo, vhi = select_rows(value_rows, vlo, vhi)
    d_lo, d_hi = u32(klo), u32(khi)
    if randomized:
        s_lo, s_hi = stream_planes(key_ids, key_seeds)
        d_lo, d_hi = d_lo ^ s_lo, d_hi ^ s_hi
    q, m = u32(queries), u32(masks)
    mm = ((d_lo ^ q[:, 0:1]) & m[:, 0:1]) | ((d_hi ^ q[:, 1:2]) & m[:, 1:2])
    bits = mm == 0                                     # (B, 512)

    slot = torch.arange(512, dtype=torch.int64, device=klo.device)[None, :]
    user = bits & (slot >= SLOTS_PER_CHUNK)            # header chunk masked
    first = torch.where(user, slot, NO_SLOT).amin(dim=1)
    found = first < NO_SLOT
    chunk = torch.clamp(first >> 3, max=63)
    vchunks = planes_to_chunk_words(vlo, vhi)          # (B, 64, 16)
    rows = torch.arange(klo.shape[0], device=klo.device)
    value = torch.where(found[:, None], vchunks[rows, chunk],
                        torch.zeros_like(vchunks[:, 0]))
    return pack_bits(bits), value, first.to(torch.int32)
