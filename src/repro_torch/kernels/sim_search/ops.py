"""Public wrapper of the sim_search kernel (csrc/sim_search.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two: a launch that
fails raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bits import u64_array_to_pairs
from repro_torch.device import resolve_device
from repro_torch.kernels import native
from repro_torch.kernels.layout import pages_to_planes, words_to_tensor
from .ref import U32, sim_search_chips_ref, sim_search_ref, to_i32

MAX_CHIPS = 65_535           # the kernel's grid puts the chips on its z axis


def sim_search(lo, hi, queries, masks, page_ids, page_seeds, *,
               randomized: bool, rows=None) -> torch.Tensor:
    """Masked multi-query search over page planes -> (Q, N, 16) bitmaps.

    lo, hi:     (cap, 512) int32 word planes (uint32 bit patterns)
    queries:    (Q, 2) int32 (lo, hi) query words;  masks: (Q, 2) int32
    page_ids:   (cap,) int32 chip-local flash address of each page
    page_seeds: (cap,) int32 device seed of each page's chip
    randomized: regenerate the §IV-C1 stream from ``page_ids``/``page_seeds``
                and cancel it out of the stored words before matching
    rows:       (N,) int32 rows of the planes to search, read in place (the
                ``PlaneStore`` arena); None searches every row (N = cap)

    Per-page addresses and seeds let one launch span chips.  The kernel
    trusts ``rows``: the caller keeps them in [0, cap).
    """
    if lo.device.type == "cpu":
        return sim_search_ref(lo, hi, queries, masks, page_ids, page_seeds,
                              randomized=randomized, rows=rows)
    n = lo.shape[0] if rows is None else rows.shape[0]
    return _launch(lo, hi, queries[None], masks[None], page_ids, page_seeds,
                   None if rows is None else rows[None], n, randomized)[0]


def sim_search_chips(lo, hi, queries, masks, page_ids, page_seeds, *,
                     randomized: bool, rows) -> torch.Tensor:
    """The chip-axis search: C chips in ONE launch -> (C, Q, N, 16) bitmaps.

    lo, hi, page_ids, page_seeds: the arena, as ``sim_search`` takes it
    queries, masks: (C, Q, 2) int32, chip c's own query rows
    rows:           (C, N) int32 arena rows of chip c's pages, read in place

    The counterpart of ``jax.vmap`` of the search kernel over the chip
    axis (the JAX package's sharded backend, ``_stacked_search``): chip
    c's queries match only chip c's rows.
    """
    if lo.device.type == "cpu":
        return sim_search_chips_ref(lo, hi, queries, masks, page_ids,
                                    page_seeds, randomized=randomized,
                                    rows=rows)
    return _launch(lo, hi, queries, masks, page_ids, page_seeds, rows,
                   rows.shape[1], randomized)


def _launch(lo, hi, queries, masks, page_ids, page_seeds, rows, n,
            randomized) -> torch.Tensor:
    """One launch over C chips: (C, Q, 2) queries and masks, (C, N) rows
    or None (rows c * N + i of the planes) -> (C, Q, N, 16)."""
    if lo.device.type != "cuda":
        raise ValueError(f"sim_search: no implementation on {lo.device}")
    device = lo.device
    cap = lo.shape[0]
    c, q = queries.shape[0], queries.shape[1]
    operands = [("lo", lo, (cap, 512)), ("hi", hi, (cap, 512)),
                ("queries", queries, (c, q, 2)), ("masks", masks, (c, q, 2)),
                ("page_ids", page_ids, (cap,)),
                ("page_seeds", page_seeds, (cap,))]
    if rows is not None:
        operands.append(("rows", rows, (c, n)))
    elif c * n != cap:
        raise ValueError(f"sim_search: {c} chips of {n} rows need {c * n} "
                         f"rows of planes, got {cap}")
    for name, t, shape in operands:
        native.check_operand(name, t, shape, device)
    if c > MAX_CHIPS:
        raise ValueError(f"{c} chips: the kernel's grid takes at most "
                         f"{MAX_CHIPS}")
    out = torch.empty((c, q, n, 16), dtype=torch.int32, device=device)
    if c and n and q:
        native.launch("sim_search_launch", lo, hi, queries, masks, page_ids,
                      page_seeds, rows, out, n, q, c, int(randomized),
                      device=device)
        native.LAUNCHES["sim_search"] += 1
    return out


def resolve_pages(n: int, device, *, page_base: int = 0, device_seed: int = 0,
                  page_ids=None, page_seeds=None):
    """Per-page stream operands as (N,) int32 tensors on ``device``: the
    given ``page_ids``/``page_seeds``, or the contiguous addresses
    ``page_base + i`` and one ``device_seed`` for every page."""
    if page_ids is None:
        page_ids = to_i32((page_base + torch.arange(n, dtype=torch.int64))
                          & U32)
    if page_seeds is None:
        page_seeds = to_i32(torch.full((n,), device_seed & U32,
                                       dtype=torch.int64))
    return page_ids.to(device), page_seeds.to(device)


def sim_search_pages(pages_bytes: np.ndarray, queries_u64, masks_u64, *,
                     randomized: bool = False, page_base: int = 0,
                     device_seed: int = 0, device=None) -> torch.Tensor:
    """Convenience: raw (N, 4096) uint8 pages and uint64 queries and masks
    -> (Q, N, 16) int32 bitmaps, on the card unless ``device`` says
    otherwise.  Page i is at flash address ``page_base + i`` on a chip of
    seed ``device_seed``."""
    device = resolve_device(device)
    lo, hi = pages_to_planes(pages_bytes)
    q = u64_array_to_pairs(np.atleast_1d(np.asarray(queries_u64, np.uint64)))
    m = u64_array_to_pairs(np.atleast_1d(np.asarray(masks_u64, np.uint64)))
    ids, seeds = resolve_pages(lo.shape[0], device, page_base=page_base,
                               device_seed=device_seed)
    return sim_search(*(words_to_tensor(a, device) for a in (lo, hi, q, m)),
                      ids, seeds, randomized=randomized)
