"""Public wrappers of the fused search+gather kernels: the cross product
(csrc/sim_fused.cu) and the paired lookup (csrc/sim_lookup.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bits import u64_array_to_pairs
from repro_torch.device import resolve_device
from repro_torch.kernels import native
from repro_torch.kernels.layout import pages_to_planes, words_to_tensor
from repro_torch.kernels.sim_search.ops import resolve_pages
from .ref import sim_fused_ref, sim_lookup_ref


def sim_fused(lo, hi, queries, masks, *, max_out: int = 16,
              page_base: int = 0, randomized: bool = False,
              device_seed: int = 0, page_ids=None, page_seeds=None):
    """Fused multi-query search+gather over page planes, one launch.

    lo, hi:          (N, 512) int32 word planes
    queries, masks:  (Q, 2) int32, or (2,) for one query — then the outputs
                     lose their leading Q axis, as the JAX package's do
    page_ids/page_seeds: (N,) int32 per-page flash addresses and seeds, so
                     one launch spans chips; by default page i is at
                     ``page_base + i`` on a chip of seed ``device_seed``
    Returns (bitmaps (Q, N, 16), gathered (Q, N, max_out, 16) — randomized
    as stored, counts (Q, N) int32 — selected chunks, header chunk
    included, those past ``max_out`` too).
    """
    single = queries.dim() == 1
    queries = queries.reshape(-1, 2).contiguous()
    masks = masks.reshape(-1, 2).contiguous()
    device = lo.device
    n, n_q = lo.shape[0], queries.shape[0]
    if max_out < 0:
        raise ValueError(f"max_out {max_out} < 0")
    page_ids, page_seeds = resolve_pages(
        n, device, page_base=page_base, device_seed=device_seed,
        page_ids=page_ids, page_seeds=page_seeds)
    if device.type == "cpu":
        bm, out, cnt = sim_fused_ref(lo, hi, queries, masks, page_ids,
                                     page_seeds, max_out=max_out,
                                     randomized=randomized)
    elif device.type == "cuda":
        for name, t, shape in (("lo", lo, (n, 512)), ("hi", hi, (n, 512)),
                               ("queries", queries, (n_q, 2)),
                               ("masks", masks, (n_q, 2)),
                               ("page_ids", page_ids, (n,)),
                               ("page_seeds", page_seeds, (n,))):
            native.check_operand(name, t, shape, device)
        bm = torch.empty((n_q, n, 16), dtype=torch.int32, device=device)
        out = torch.empty((n_q, n, max_out, 16), dtype=torch.int32,
                          device=device)
        cnt = torch.empty((n_q, n), dtype=torch.int32, device=device)
        if n and n_q:
            native.launch("sim_fused_launch", lo, hi, queries, masks,
                          page_ids, page_seeds, bm, out, cnt, n, n_q, max_out,
                          int(randomized), device=device)
            native.LAUNCHES["sim_fused"] += 1
    else:
        raise ValueError(f"sim_fused: no implementation on {device}")
    if single:
        return bm[0], out[0], cnt[0]
    return bm, out, cnt


def sim_fused_pages(pages_bytes: np.ndarray, queries_u64, masks_u64, *,
                    device=None, **kw):
    """Convenience: raw (N, 4096) uint8 pages and uint64 queries and masks
    through :func:`sim_fused`, on the card unless ``device`` says
    otherwise.  ``kw`` are :func:`sim_fused`'s keywords."""
    device = resolve_device(device)
    lo, hi = pages_to_planes(pages_bytes)
    q = u64_array_to_pairs(np.atleast_1d(np.asarray(queries_u64, np.uint64)))
    m = u64_array_to_pairs(np.atleast_1d(np.asarray(masks_u64, np.uint64)))
    return sim_fused(*(words_to_tensor(a, device) for a in (lo, hi, q, m)),
                     **kw)


def sim_fused_lookup(klo, khi, vlo, vhi, queries, masks, key_ids, key_seeds,
                     *, randomized: bool, key_rows=None, value_rows=None):
    """Paired lookup burst: search key row i, gather value row i, 1 launch.

    klo, khi, vlo, vhi: (cap, 512) int32 key-page and value-page planes (one
                        arena may be passed as both)
    queries, masks:     (B, 2) int32 per-row query and mask words
    key_ids, key_seeds: (cap,) int32 flash addresses and seeds of the key
                        planes' rows
    key_rows, value_rows: (B,) int32 rows of the key and value planes for
                        row i, read in place; None means row i (cap = B)
    Returns (bitmaps (B, 16), value_words (B, 16) — randomized as stored,
    slots (B,) int32 with 512 meaning "no user slot matched").  The kernel
    trusts the row indices: the caller keeps them in [0, cap).
    """
    if klo.device.type == "cpu":
        return sim_lookup_ref(klo, khi, vlo, vhi, queries, masks, key_ids,
                              key_seeds, randomized=randomized,
                              key_rows=key_rows, value_rows=value_rows)
    if klo.device.type != "cuda":
        raise ValueError(f"sim_fused_lookup: no implementation on "
                         f"{klo.device}")
    device = klo.device
    b = queries.shape[0]
    kcap = b if key_rows is None else klo.shape[0]
    vcap = b if value_rows is None else vlo.shape[0]
    operands = [("klo", klo, (kcap, 512)), ("khi", khi, (kcap, 512)),
                ("vlo", vlo, (vcap, 512)), ("vhi", vhi, (vcap, 512)),
                ("queries", queries, (b, 2)), ("masks", masks, (b, 2)),
                ("key_ids", key_ids, (kcap,)),
                ("key_seeds", key_seeds, (kcap,))]
    for name, rows in (("key_rows", key_rows), ("value_rows", value_rows)):
        if rows is not None:
            operands.append((name, rows, (b,)))
    for name, t, shape in operands:
        native.check_operand(name, t, shape, device)
    bm = torch.empty((b, 16), dtype=torch.int32, device=device)
    val = torch.empty((b, 16), dtype=torch.int32, device=device)
    slots = torch.empty((b,), dtype=torch.int32, device=device)
    if b:
        native.launch("sim_lookup_launch", klo, khi, vlo, vhi, queries, masks,
                      key_ids, key_seeds, key_rows, value_rows, bm, val,
                      slots, b, int(randomized), device=device)
        native.LAUNCHES["sim_lookup"] += 1
    return bm, val, slots
