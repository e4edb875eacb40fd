"""Public wrapper of the fused range-plan kernel (csrc/sim_plan.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two: a launch that
fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import sim_plan_chips_ref, sim_plan_ref

MAX_GROUPS = 65_535          # the kernel's grid puts the groups on its y axis
MAX_CHIPS = 65_535           # ...and the chips on its z axis


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
    return _launch(lo[None], hi[None], queries[None], masks[None],
                   flags[None], page_ids[None], page_seeds[None],
                   randomized)[0]


def sim_plan_chips(lo, hi, queries, masks, flags, page_ids, page_seeds, *,
                   randomized: bool) -> torch.Tensor:
    """The chip-axis plan: C chips in ONE launch -> (C, G, N, 16) bitmaps.

    lo, hi:     (C, N, 512) int32 planes, chip c's pages (``take2d``)
    queries:    (C, G, P, 2) int32 pass rows;  masks: (C, G, P, 2) int32
    flags:      (C, G, P) int32
    page_ids:   (C, N) int32;  page_seeds: (C, N) int32

    The counterpart of ``jax.vmap`` of the plan kernel over the chip axis
    (the JAX package's sharded backend, ``_stacked_plan``): chip c's
    groups see only chip c's pages.
    """
    if lo.device.type == "cpu":
        return sim_plan_chips_ref(lo, hi, queries, masks, flags, page_ids,
                                  page_seeds, randomized=randomized)
    return _launch(lo, hi, queries, masks, flags, page_ids, page_seeds,
                   randomized)


def _launch(lo, hi, queries, masks, flags, page_ids, page_seeds,
            randomized) -> torch.Tensor:
    """One launch over C chips of (C, N, 512) planes and (C, G, P) pass
    rows -> (C, G, N, 16)."""
    if lo.device.type != "cuda":
        raise ValueError(f"sim_plan: no implementation on {lo.device}")
    device = lo.device
    c, n = lo.shape[0], lo.shape[1]
    g, p = queries.shape[1], queries.shape[2]
    for name, t, shape in (("lo", lo, (c, n, 512)), ("hi", hi, (c, n, 512)),
                           ("queries", queries, (c, g, p, 2)),
                           ("masks", masks, (c, g, p, 2)),
                           ("flags", flags, (c, g, p)),
                           ("page_ids", page_ids, (c, n)),
                           ("page_seeds", page_seeds, (c, n))):
        native.check_operand(name, t, shape, device)
    if g > MAX_GROUPS:
        raise ValueError(f"{g} plan groups: the kernel's grid takes at most "
                         f"{MAX_GROUPS}")
    if c > MAX_CHIPS:
        raise ValueError(f"{c} chips: the kernel's grid takes at most "
                         f"{MAX_CHIPS}")
    out = torch.empty((c, g, n, 16), dtype=torch.int32, device=device)
    if c and n and g:
        native.launch("sim_plan_launch", lo, hi, queries, masks, flags,
                      page_ids, page_seeds, out, n, g, p, c, int(randomized),
                      device=device)
        native.LAUNCHES["sim_plan"] += 1
    return out
