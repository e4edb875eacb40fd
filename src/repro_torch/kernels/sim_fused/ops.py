"""Public wrapper of the paired lookup kernel (csrc/sim_lookup.cu).

A CUDA tensor launches the kernel; a CPU tensor takes the plain PyTorch
version in ref.py.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import sim_lookup_ref


def sim_fused_lookup(klo, khi, vlo, vhi, queries, masks, key_ids, key_seeds,
                     *, randomized: bool):
    """Paired lookup burst: search key row i, gather value row i, 1 launch.

    klo, khi, vlo, vhi: (B, 512) int32 key-page and value-page planes
    queries, masks:     (B, 2) int32 per-row query and mask words
    key_ids, key_seeds: (B,) int32 key-page flash addresses and seeds
    Returns (bitmaps (B, 16), value_words (B, 16) — randomized as stored,
    slots (B,) int32 with 512 meaning "no user slot matched").
    """
    if klo.device.type == "cpu":
        return sim_lookup_ref(klo, khi, vlo, vhi, queries, masks, key_ids,
                              key_seeds, randomized=randomized)
    if klo.device.type != "cuda":
        raise ValueError(f"sim_fused_lookup: no implementation on "
                         f"{klo.device}")
    device = klo.device
    b = klo.shape[0]
    for name, t, shape in (("klo", klo, (b, 512)), ("khi", khi, (b, 512)),
                           ("vlo", vlo, (b, 512)), ("vhi", vhi, (b, 512)),
                           ("queries", queries, (b, 2)),
                           ("masks", masks, (b, 2)),
                           ("key_ids", key_ids, (b,)),
                           ("key_seeds", key_seeds, (b,))):
        native.check_operand(name, t, shape, device)
    bm = torch.empty((b, 16), dtype=torch.int32, device=device)
    val = torch.empty((b, 16), dtype=torch.int32, device=device)
    slots = torch.empty((b,), dtype=torch.int32, device=device)
    if b:
        native.launch("sim_lookup_launch", klo, khi, vlo, vhi, queries, masks,
                      key_ids, key_seeds, bm, val, slots, b, int(randomized),
                      device=device)
        native.LAUNCHES["sim_lookup"] += 1
    return bm, val, slots
