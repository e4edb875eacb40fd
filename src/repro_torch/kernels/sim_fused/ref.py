"""Plain PyTorch version of the paired lookup kernel (csrc/sim_lookup.cu).

Only the lookup form of the JAX package's sim_fused module is ported so
far; its cross-product search+gather kernel is not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.layout import planes_to_chunk_words
from repro_torch.kernels.sim_search.ref import pack_bits, stream_planes, u32

NO_SLOT = 512            # first-match sentinel: no user slot matched
SLOTS_PER_CHUNK = 8


def sim_lookup_ref(klo, khi, vlo, vhi, queries, masks, key_ids, key_seeds, *,
                   randomized: bool):
    """Paired lookup: query i vs key row i, value gather from row i.

    Returns (bitmaps (B, 16) int32 — every match, header slots included;
    value_words (B, 16) int32 — chunk ``min(slot >> 3, 63)`` of value row i,
    randomized as stored, zeros on a miss; slots (B,) int32 — first
    matching user slot (>= 8), 512 if none).
    """
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
