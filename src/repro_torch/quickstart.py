"""Quickstart: the SiM command set in five minutes.

Builds a flash page of keys, runs search and gather commands against the
functional chip, then the same operations through the hand-written CUDA
kernels on the card (or their plain PyTorch versions with
``device="cpu"``), and shows the I/O arithmetic that motivates the paper
(Table I).

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import Command, SimChip, pair_to_u64, unpack_bitmap
from repro_torch.core.bits import (chunk_bitmap_from_slot_bitmap,
                                   u64_array_to_pairs)
from repro_torch.core.page import build_page, mask_header_slots
from repro_torch.device import resolve_device
from repro_torch.kernels.layout import (pages_to_planes, tensor_to_words,
                                        words_to_tensor)
from repro_torch.kernels.sim_fused.ops import sim_fused
from repro_torch.kernels.sim_search.ops import sim_search_pages

FULL_MASK = 0xFFFFFFFFFFFFFFFF


def main(device=None) -> dict:
    """Run the five steps; return their outputs as numpy arrays and ints:
    ``slot`` and ``key`` (steps 2–3), ``search`` (step 4's (1, 4, 16)
    bitmaps), ``hits`` (its (page, slot) pairs) and ``fused`` (step 5's
    bitmaps, gathered chunks and counts)."""
    device = resolve_device(device)
    print("=== 1. program a page of keys into the chip ===")
    chip = SimChip(n_pages=16, device_seed=42)
    keys = np.arange(10_000, 10_504, dtype=np.uint64)      # 504 keys
    chip.program_entries(3, keys, timestamp_ns=1_000)
    print(f"stored {len(keys)} 8-byte keys in one 4 KiB page "
          f"(randomized on flash)")

    print("\n=== 2. search: ship the 8-byte query, get a 64 B bitmap ===")
    resp = chip.search(Command.search(3, 10_123))
    bitmap = mask_header_slots(resp.bitmap_words)
    slot = int(np.nonzero(unpack_bitmap(bitmap, 512))[0][0])
    print(f"search(10123) -> match at slot {slot} "
          f"(bitmap is {resp.bitmap_words.nbytes} bytes on the bus)")

    print("\n=== 3. gather: fetch only the matching 64 B chunk ===")
    cb = pair_to_u64(*chunk_bitmap_from_slot_bitmap(bitmap))
    g = chip.gather(Command.gather(3, cb))
    off = (slot % 8) * 8
    key = int.from_bytes(bytes(g.chunks[0][off:off + 8]), "little")
    print(f"gather -> {len(g.chunk_ids)} chunk(s), inner-parity ok="
          f"{bool(g.parity_ok.all())}, decoded key={key}")
    print(f"I/O: SiM moved {64 + 64} B; a page read moves 4096 B "
          f"({4096 // 128}x more)")

    print(f"\n=== 4. the same search through the CUDA kernel ({device}) ===")
    pages = np.stack([build_page(keys + 504 * p, p, device_seed=7).raw
                      for p in range(4)])
    search = tensor_to_words(sim_search_pages(
        pages, [10_623], [FULL_MASK], randomized=True, device_seed=7,
        device=device))
    hits = list(zip(*(a.tolist() for a in np.nonzero(
        unpack_bitmap(search[0])))))
    print(f"kernel search over 4 pages -> hit (page, slot) = {hits}")

    print("\n=== 5. fused search+gather (one page pass) ===")
    lo, hi = pages_to_planes(pages)
    q = u64_array_to_pairs(np.array([10_623], dtype=np.uint64))[0]
    m = u64_array_to_pairs(np.array([FULL_MASK], dtype=np.uint64))[0]
    bm, gathered, counts = sim_fused(
        *(words_to_tensor(a, device) for a in (lo, hi, q, m)), max_out=4,
        randomized=True, device_seed=7)
    fused = (tensor_to_words(bm), tensor_to_words(gathered),
             counts.cpu().numpy())
    print(f"fused: per-page chunk counts = {fused[2].tolist()}")
    print("\nDone — see repro_torch.launch.serve for the serving path.")
    return {"slot": slot, "key": key, "search": search, "hits": hits,
            "fused": fused}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    main(ap.parse_args().device)
