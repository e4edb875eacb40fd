"""Public wrapper of the sim_gather kernel (csrc/sim_gather.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import sim_gather_ref


def sim_gather(lo, hi, bitmap, max_out: int, *, rows=None):
    """Gather the selected chunks of each page, read from page planes.

    lo, hi: (cap, 512) int32 word planes (uint32 bit patterns)
    bitmap: (N, 2) int32 (lo, hi) 64-bit chunk-select bitmap per page
    rows:   (N,) int32 rows of the planes to gather from, read in place
            (the ``PlaneStore`` arena); None gathers from every row
            (N = cap)
    returns (gathered (N, max_out, 16) int32 — selected chunks
    front-packed in chunk order, zeros after them, chunk j's word 2s the
    lo word of slot 8j + s and word 2s + 1 its hi word; counts (N,) int32
    — selections made, including any dropped past ``max_out``).

    The bitmap is taken as given (the header chunk is not masked) and the
    chunks leave as stored (randomized pages stay randomized).  The kernel
    trusts ``rows``: the caller keeps them in [0, cap).
    """
    if lo.device.type == "cpu":
        return sim_gather_ref(lo, hi, bitmap, max_out, rows=rows)
    if lo.device.type != "cuda":
        raise ValueError(f"sim_gather: no implementation on {lo.device}")
    if max_out < 0:
        raise ValueError(f"max_out must be >= 0, got {max_out}")
    device = lo.device
    cap = lo.shape[0]
    n = cap if rows is None else rows.shape[0]
    operands = [("lo", lo, (cap, 512)), ("hi", hi, (cap, 512)),
                ("bitmap", bitmap, (n, 2))]
    if rows is not None:
        operands.append(("rows", rows, (n,)))
    for name, t, shape in operands:
        native.check_operand(name, t, shape, device)
    out = torch.empty((n, max_out, 16), dtype=torch.int32, device=device)
    counts = torch.empty((n,), dtype=torch.int32, device=device)
    if n:
        native.launch("sim_gather_launch", lo, hi, rows, bitmap, out, counts,
                      n, max_out, device=device)
        native.LAUNCHES["sim_gather"] += 1
    return out, counts
