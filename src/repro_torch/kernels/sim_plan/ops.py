"""Public wrapper of the fused range-plan kernel (csrc/sim_plan.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two: a launch that
fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import sim_plan_ref


def sim_plan(lo, hi, queries, masks, flags, page_ids, page_seeds, *,
             randomized: bool) -> torch.Tensor:
    """Fused multi-pass plan evaluation -> (G, N, 16) combined bitmaps.

    lo, hi:     (N, 512) int32 word planes (uint32 bit patterns)
    queries:    (G, P, 2) int32 pass rows;  masks: (G, P, 2) int32
    flags:      (G, P) int32 — PASS_INCLUDE / PASS_EXCLUDE / PASS_PAD
    page_ids:   (N,) int32 chip-local flash address of each page
    page_seeds: (N,) int32 device seed of each page's chip
    randomized: regenerate the §IV-C1 stream and cancel it out of the
                stored words before matching

    ONE combined bitmap per (plan group, page) leaves the kernel, not one
    per pass (paper Fig 10).
    """
    if lo.device.type == "cpu":
        return sim_plan_ref(lo, hi, queries, masks, flags, page_ids,
                            page_seeds, randomized=randomized)
    if lo.device.type != "cuda":
        raise ValueError(f"sim_plan: no implementation on {lo.device}")
    device = lo.device
    n = lo.shape[0]
    g, p = queries.shape[0], queries.shape[1]
    for name, t, shape in (("lo", lo, (n, 512)), ("hi", hi, (n, 512)),
                           ("queries", queries, (g, p, 2)),
                           ("masks", masks, (g, p, 2)),
                           ("flags", flags, (g, p)),
                           ("page_ids", page_ids, (n,)),
                           ("page_seeds", page_seeds, (n,))):
        native.check_operand(name, t, shape, device)
    out = torch.empty((g, n, 16), dtype=torch.int32, device=device)
    if n and g:
        native.launch("sim_plan_launch", lo, hi, queries, masks, flags,
                      page_ids, page_seeds, out, n, g, p, int(randomized),
                      device=device)
        native.LAUNCHES["sim_plan"] += 1
    return out
