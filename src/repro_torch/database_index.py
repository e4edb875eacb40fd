"""Database indexes on SiM (paper §V-A/B): B+Tree primary index, extendible
hash index, and the I/O ledger against the CPU-centric baseline.

The B+Tree and the hash index issue their searches through the batched
backend: point lookups as one ``sim_lookup`` launch a burst, the range
query as one ``sim_plan`` launch and one ``sim_gather`` launch, hash probes
as one ``sim_search`` and one ``sim_gather`` launch, and every bucket split
as one of each — on the card, or as the kernels' plain PyTorch versions
with ``device="cpu"``.  The baseline reads whole pages on the host.

Run:  PYTHONPATH=src python -m repro_torch.database_index [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.backend import make_backend
from repro_torch.core.engine import SimChipArray
from repro_torch.device import resolve_device
from repro_torch.index.baseline import BaselineBTree
from repro_torch.index.btree import SimBTree
from repro_torch.index.hashindex import SimHashIndex


def main(device=None) -> dict:
    """Run the three parts; return their numbers: the lookups that agreed
    with the baseline and both sides' I/O for them, the range's rows, and
    the hash index's splits and directory depth."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    keys = (rng.choice(10**9, size=5000, replace=False) + 1).astype(np.uint64)
    values = keys * np.uint64(17)

    print(f"=== B+Tree primary index (leaves on SiM, {device}) ===")
    bt = SimBTree(make_backend("batched", SimChipArray(n_chips=8,
                                                        pages_per_chip=64),
                               device=device))
    bt.bulk_load(keys, values)
    bb = BaselineBTree(SimChipArray(n_chips=8, pages_per_chip=64))
    bb.bulk_load(keys, values)
    probes = [int(k) for k in rng.choice(keys, size=200, replace=False)]
    got = bt.lookup_batch(probes)
    for k, v in zip(probes, got):
        assert v == bb.lookup(k) == k * 17
    io = {"lookups_agreed": len(probes),
          "sim_io_bytes": bt.stats.bitmap_bytes + bt.stats.chunk_bytes,
          "searches": bt.stats.searches, "gathers": bt.stats.gathers,
          "baseline_io_bytes": bb.bytes_read,
          "baseline_pages": bb.pages_read}
    print(f"{len(probes)} point lookups agree with baseline (one burst)")
    print(f"  SiM I/O:      {io['sim_io_bytes']:>10,} B "
          f"({io['searches']} searches, {io['gathers']} gathers)")
    print(f"  baseline I/O: {io['baseline_io_bytes']:>10,} B "
          f"({io['baseline_pages']} full pages)")
    print(f"  reduction:    "
          f"{io['baseline_io_bytes'] / io['sim_io_bytes']:.0f}x")

    print("\n=== range query (exact prefix decomposition, §V-C) ===")
    lo, hi = int(np.percentile(keys, 50)), int(np.percentile(keys, 52))
    r_sim = sorted(bt.range_query(lo, hi))
    assert r_sim == sorted(bb.range_query(lo, hi))
    print(f"range [{lo}, {hi}) -> {len(r_sim)} rows, results identical")

    print("\n=== extendible hash index (bucket splits via §V-D) ===")
    h = SimHashIndex(make_backend("batched", SimChipArray(n_chips=8,
                                                          pages_per_chip=512),
                                  device=device))
    for k in keys[:3000]:
        h.insert(int(k), int(k) % 99991)
    probe = [int(k) for k in keys[:3000:17]]
    ok = h.lookup_batch(probe) == [k % 99991 for k in probe]
    print(f"3000 inserts, lookups ok={ok}, bucket splits={h.splits} "
          f"(each split = 1 search + gather redistribution), "
          f"directory depth={h.global_depth}")
    return {**io, "range": (lo, hi), "range_rows": r_sim, "hash_ok": ok,
            "splits": h.splits,
            "split_gathered_chunks": h.split_gathered_chunks,
            "global_depth": h.global_depth}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    main(ap.parse_args().device)
