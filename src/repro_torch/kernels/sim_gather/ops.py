"""Public wrapper of the sim_gather kernel (csrc/sim_gather.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import sim_gather_ref


def sim_gather(chunks, bitmap, max_out: int):
    """Gather the selected chunks of each page.

    chunks: (N, 64, 16) int32 chunk words;  bitmap: (N, 2) int32 (lo, hi)
    returns (gathered (N, max_out, 16) int32 — selected chunks front-packed
    in chunk order, zeros after them; counts (N,) int32 — selections made,
    including any dropped past ``max_out``).
    """
    if chunks.device.type == "cpu":
        return sim_gather_ref(chunks, bitmap, max_out)
    if chunks.device.type != "cuda":
        raise ValueError(f"sim_gather: no implementation on {chunks.device}")
    if max_out < 0:
        raise ValueError(f"max_out must be >= 0, got {max_out}")
    device = chunks.device
    n = chunks.shape[0]
    native.check_operand("chunks", chunks, (n, 64, 16), device)
    native.check_operand("bitmap", bitmap, (n, 2), device)
    out = torch.empty((n, max_out, 16), dtype=torch.int32, device=device)
    counts = torch.empty((n,), dtype=torch.int32, device=device)
    if n:
        native.launch("sim_gather_launch", chunks, bitmap, out, counts, n,
                      max_out, device=device)
        native.LAUNCHES["sim_gather"] += 1
    return out, counts
