"""Frozen yardstick of the SiM kernels' work: operations and bytes of one
launch, and the H100's peaks they are held to.

The formulas are ``chip_smoke.py``'s ``lookup_bound``, ``plan_bound``,
``gather_bound`` and ``bound`` as they stood when the benchmark was
defined, taking numpy words (uint32 bit patterns) where the smoke takes
device tensors.  Each input byte is counted once and each output byte
once; the benchmark passes the rows the work needs (the burst's real
lookups, the plan's real pages, the gathers' real rows), not the padded
launch geometry.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth.
HBM_BW = 3.35e12
# 32-bit integer operations a second: 132 SMs x 64 INT32 lanes x 1.98 GHz
# boost clock.  Derived from the SM's layout, not a data-sheet figure.
INT32_OPS = 132 * 64 * 1.98e9
# 32-bit operations of the §IV-C1 randomization stream for one slot:
# counter (3) + two mix2_32 of 17 each + XOR into the lo and hi words (2).
STREAM_OPS = 39
# Per (query, slot) match: 2 XOR, 2 AND, 1 OR, 1 compare.
MATCH_OPS = 6
# Per (real plan pass, slot): the match and an OR into its accumulator.
PASS_OPS = MATCH_OPS + 1
NO_SLOT = 512


def popcount64(words: np.ndarray) -> np.ndarray:
    """Set bits of each (lo, hi) uint32 pair of an (N, 2) array."""
    w = np.asarray(words, np.uint32).astype(np.uint64)
    v = w[:, 0] | (w[:, 1] << np.uint64(32))
    return np.array([bin(int(x)).count("1") for x in v], np.int64)


def lookup_bound(n_rows: int, slots, in_place: bool = False):
    """Work of one fused lookup launch over ``n_rows`` lookups whose first
    matching slots are ``slots`` (NO_SLOT: a miss): the key planes, one 64 B
    value chunk a hit, the outputs; ``in_place`` adds the two (B,) row
    indices read."""
    hits = int((np.asarray(slots) < NO_SLOT).sum())
    ops = n_rows * 512 * (STREAM_OPS + MATCH_OPS) + n_rows * 16
    nbytes = (2 * n_rows * 512 * 4 + 2 * n_rows * 2 * 4 + 2 * n_rows * 4
              + hits * 64 + n_rows * (64 + 64 + 4) + in_place * n_rows * 8)
    return ops, nbytes


def gather_bound(bitmap, max_out: int, in_place: bool = False):
    """Work of one gather launch over (N, 2) chunk bitmaps: the bitmaps,
    the kept chunks read once, the outputs written once; ``in_place`` adds
    the (N,) row indices read."""
    bm = np.asarray(bitmap, np.uint32).reshape(-1, 2)
    counts = popcount64(bm)
    n = bm.shape[0]
    ops = n * 64 * 4                          # shift, test, popcount, compare
    nbytes = (n * 8 + int(np.minimum(counts, max_out).sum()) * 64
              + n * max_out * 64 + n * 4 + in_place * n * 4)
    return ops, nbytes


def plan_bound(flags, n_pages: int):
    """Work of one plan launch over ``n_pages`` pages with (G, P) pass
    flags (0: a pad row): the stream once per (page, slot), the real passes
    per slot, the combine and ballots per (group, page)."""
    f = np.asarray(flags)
    n_groups, p_pad = f.shape
    real = int((f != 0).sum())
    ops = (n_pages * 512 * STREAM_OPS + real * n_pages * 512 * PASS_OPS
           + n_groups * n_pages * (512 + 16))
    nbytes = (2 * n_pages * 512 * 4 + n_groups * p_pad * 5 * 4
              + 2 * n_pages * 4 + n_groups * n_pages * 16 * 4)
    return ops, nbytes


def bound(ops, nbytes):
    """The least time in ms the H100 could take, and what bounds it."""
    t_ops, t_bytes = ops / INT32_OPS, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
