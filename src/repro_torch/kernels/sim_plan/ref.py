"""Plain PyTorch version of the fused range-plan kernel (csrc/sim_plan.cu),
and the pass-row layout its callers build.

A plan group is P pass rows: a (q_lo, q_hi) query, an (m_lo, m_hi) mask
and a flag.  The combined bitmap of a (group, page) is the OR of the
include passes' matches AND-NOT the OR of the exclude passes' matches
(paper Fig 10); PASS_PAD rows enter neither.  Words are int64 masked to
32 bits, as in sim_search/ref.py.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.sim_search.ref import pack_bits, stream_planes, u32

# Pass flags: how a pass row enters the in-latch accumulation.
PASS_PAD = 0        # padding row — contributes to neither accumulator
PASS_INCLUDE = 1    # OR into the include accumulator
PASS_EXCLUDE = 2    # OR into the exclude accumulator (AND-NOT at the end)


def plan_pass_rows(include, exclude, n_passes: int):
    """Dense (P, 2)/(P, 2)/(P,) uint32 pass operands from a plan's pass pairs.

    ``include``/``exclude`` are sequences of ``((q_lo, q_hi), (m_lo, m_hi))``
    uint32 pair tuples (the ``Command.plan`` wire format); rows past the
    real passes are PASS_PAD (q = 0, m = 0) and enter neither accumulator.
    """
    if n_passes < len(include) + len(exclude):
        raise ValueError((n_passes, len(include), len(exclude)))
    q = np.zeros((n_passes, 2), dtype=np.uint32)
    m = np.zeros_like(q)
    f = np.zeros(n_passes, dtype=np.uint32)
    for i, (qp, mp) in enumerate(include):
        q[i], m[i], f[i] = qp, mp, PASS_INCLUDE
    base = len(include)
    for i, (qp, mp) in enumerate(exclude):
        q[base + i], m[base + i], f[base + i] = qp, mp, PASS_EXCLUDE
    return q, m, f


def sim_plan_ref(lo, hi, queries, masks, flags, page_ids, page_seeds, *,
                 randomized: bool) -> torch.Tensor:
    """Fused range-plan evaluation.

    lo, hi:   (N, 512) int32 planes;  page_ids, page_seeds: (N,) int32
    queries:  (G, P, 2) int32 pass rows;  masks: (G, P, 2) int32
    flags:    (G, P) int32 — PASS_INCLUDE / PASS_EXCLUDE / PASS_PAD
    Returns (G, N, 16) int32 combined bitmaps.
    """
    d_lo, d_hi = u32(lo), u32(hi)
    if randomized:
        s_lo, s_hi = stream_planes(page_ids, page_seeds)
        d_lo, d_hi = d_lo ^ s_lo, d_hi ^ s_hi
    q, m, f = u32(queries), u32(masks), u32(flags)
    hit = (((d_lo ^ q[..., 0, None, None]) & m[..., 0, None, None])
           | ((d_hi ^ q[..., 1, None, None]) & m[..., 1, None, None])) == 0
    inc = (hit & (f == PASS_INCLUDE)[..., None, None]).any(dim=1)
    exc = (hit & (f == PASS_EXCLUDE)[..., None, None]).any(dim=1)
    return pack_bits(inc & ~exc)                       # (G, N, 16)
