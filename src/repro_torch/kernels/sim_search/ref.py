"""Plain PyTorch version of the sim_search kernel.

PyTorch on the CPU has no ``uint32`` shifts, adds or minimums, and shifts of
``int32`` are arithmetic, so these versions carry every 32-bit word in an
``int64`` masked to 32 bits after each multiply.  Inputs and outputs are
``int32`` bit patterns, as the kernels take and give them.
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
_LO_SALT = 0x9E3779B9
_HI_SALT = 0x7F4A7C15
SLOTS = 512


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the unsigned value."""
    return t.to(torch.int64) & U32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> int32 bit pattern."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & U32
    return x ^ (x >> 16)


def mix2_32(x: torch.Tensor, salt: int) -> torch.Tensor:
    return fmix32(fmix32(x) ^ salt)


def stream_planes(page_ids: torch.Tensor, page_seeds: torch.Tensor):
    """§IV-C1 stream of each page as (N, 512) lo and hi int64 planes: the
    counter of slot s of page p is ``(page_ids[p] * 512 + s) ^ seed[p]``."""
    slot = torch.arange(SLOTS, dtype=torch.int64, device=page_ids.device)
    ctr = ((u32(page_ids)[:, None] * SLOTS + slot[None, :]) & U32) \
        ^ u32(page_seeds)[:, None]
    return mix2_32(ctr, _LO_SALT), mix2_32(ctr, _HI_SALT)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 512) {0,1} -> (..., 16) int32 bitmap; bit i of word w is slot
    32w + i."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], SLOTS // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return to_i32((b << shifts).sum(dim=-1))


def select_rows(rows, *planes):
    """The ``rows`` of each of ``planes`` (all of them for ``rows=None``)."""
    if rows is None:
        return planes
    idx = rows.to(torch.int64)
    return tuple(p.index_select(0, idx) for p in planes)


def sim_search_ref(lo, hi, queries, masks, page_ids, page_seeds, *,
                   randomized: bool, rows=None) -> torch.Tensor:
    """Masked multi-query search.

    lo, hi: (cap, 512) int32 planes; queries, masks: (Q, 2) int32;
    page_ids, page_seeds: (cap,) int32; rows: (N,) int32 rows of the planes
    to search, or None for all of them (N = cap).  Returns (Q, N, 16) int32
    bitmaps.
    """
    lo, hi, page_ids, page_seeds = select_rows(rows, lo, hi, page_ids,
                                               page_seeds)
    d_lo, d_hi = u32(lo), u32(hi)
    if randomized:
        s_lo, s_hi = stream_planes(page_ids, page_seeds)
        d_lo, d_hi = d_lo ^ s_lo, d_hi ^ s_hi
    q, m = u32(queries), u32(masks)
    mm = ((d_lo[None] ^ q[:, 0, None, None]) & m[:, 0, None, None]) | (
        (d_hi[None] ^ q[:, 1, None, None]) & m[:, 1, None, None])
    return pack_bits(mm == 0)                          # (Q, N, 16)


def sim_search_chips_ref(lo, hi, queries, masks, page_ids, page_seeds, *,
                         randomized: bool, rows) -> torch.Tensor:
    """The chip-axis search: chip c's (Q, 2) queries and masks against the
    arena rows ``rows[c]``, for each of the C chips.

    lo, hi: (cap, 512) int32 planes; page_ids, page_seeds: (cap,) int32;
    queries, masks: (C, Q, 2) int32; rows: (C, N) int32.  Returns
    (C, Q, N, 16) int32 bitmaps.
    """
    return torch.stack([
        sim_search_ref(lo, hi, q, m, page_ids, page_seeds,
                       randomized=randomized, rows=r)
        for q, m, r in zip(queries, masks, rows)])
