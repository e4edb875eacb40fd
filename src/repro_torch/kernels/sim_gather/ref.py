"""Plain PyTorch version of the sim_gather kernel (index ops only, so it
runs unchanged on the CPU and on the card, in any integer dtype)."""
from __future__ import annotations

import torch

from repro_torch.kernels.layout import planes_to_chunk_words
from repro_torch.kernels.sim_search.ref import select_rows, u32


def compact_chunks(chunks, bitmap, max_out: int):
    """Order-preserving chunk compaction per page.

    chunks: (N, 64, 16) int32 chunk-major page words
    bitmap: (N, 2) int32 — 64-bit chunk-select bitmap per page (lo, hi)
    returns (gathered (N, max_out, 16) int32, counts (N,) int32).
    Selected chunks pack to the front in chunk order; the tail is zero.
    Chunks beyond ``max_out`` selections are dropped (counts still report
    the true total, so the host can re-issue a follow-up gather).
    """
    n = chunks.shape[0]
    bm = u32(bitmap)
    j = torch.arange(64, dtype=torch.int64, device=chunks.device)
    word = torch.where(j[None, :] < 32, bm[:, 0:1], bm[:, 1:2])   # (N, 64)
    bit = (word >> (j % 32)) & 1                                   # (N, 64)
    pos = torch.cumsum(bit, dim=1) - bit                           # (N, 64)
    # Output row of each kept chunk; dropped and unselected chunks go to a
    # spill column (max_out) that is cut off below.
    dest = torch.where((bit == 1) & (pos < max_out), pos, max_out)
    # Source chunk of each output row; 64 names an all-zero chunk.
    src = torch.full((n, max_out + 1), 64, dtype=torch.int64,
                     device=chunks.device)
    src.scatter_(1, dest, j.expand(n, 64).contiguous())
    padded = torch.cat([chunks, chunks.new_zeros((n, 1, 16))], dim=1)
    gathered = torch.gather(padded, 1,
                            src[:, :max_out, None].expand(n, max_out, 16))
    return gathered, bit.sum(dim=1).to(torch.int32)


def sim_gather_ref(lo, hi, bitmap, max_out: int, *, rows=None):
    """The chunks each page's bitmap selects, read from page planes.

    lo, hi: (cap, 512) int32 planes; bitmap: (N, 2) int32; rows: (N,) int32
    rows of the planes to gather from, or None for all of them (N = cap).
    Chunk j's word 2s is slot 8j + s's lo word, word 2s + 1 its hi word.
    Returns :func:`compact_chunks` of those pages.
    """
    lo, hi = select_rows(rows, lo, hi)
    return compact_chunks(planes_to_chunk_words(lo, hi), bitmap, max_out)
