"""Public wrapper of the sim_search kernel (csrc/sim_search.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two: a launch that
fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import sim_search_ref


def sim_search(lo, hi, queries, masks, page_ids, page_seeds, *,
               randomized: bool) -> torch.Tensor:
    """Masked multi-query search over page planes -> (Q, N, 16) bitmaps.

    lo, hi:     (N, 512) int32 word planes (uint32 bit patterns)
    queries:    (Q, 2) int32 (lo, hi) query words;  masks: (Q, 2) int32
    page_ids:   (N,) int32 chip-local flash address of each page
    page_seeds: (N,) int32 device seed of each page's chip
    randomized: regenerate the §IV-C1 stream from ``page_ids``/``page_seeds``
                and cancel it out of the stored words before matching

    Per-page addresses and seeds let one launch span chips.
    """
    if lo.device.type == "cpu":
        return sim_search_ref(lo, hi, queries, masks, page_ids, page_seeds,
                              randomized=randomized)
    if lo.device.type != "cuda":
        raise ValueError(f"sim_search: no implementation on {lo.device}")
    device = lo.device
    n, q = lo.shape[0], queries.shape[0]
    for name, t, shape in (("lo", lo, (n, 512)), ("hi", hi, (n, 512)),
                           ("queries", queries, (q, 2)),
                           ("masks", masks, (q, 2)),
                           ("page_ids", page_ids, (n,)),
                           ("page_seeds", page_seeds, (n,))):
        native.check_operand(name, t, shape, device)
    out = torch.empty((q, n, 16), dtype=torch.int32, device=device)
    if n and q:
        native.launch("sim_search_launch", lo, hi, queries, masks, page_ids,
                      page_seeds, out, n, q, int(randomized), device=device)
        native.LAUNCHES["sim_search"] += 1
    return out
