"""Analytical range scans on a BitWeaving-packed secondary index (paper
Fig 9/10): exact prefix decomposition vs the paper's one-pass approximate
plan, with pass counts and false-positive rates.  The counterpart of the
JAX package's ``examples/range_query_analytics.py``, whose index runs on
``ScalarBackend``: here the index runs on the batched backend, so each
select is one ``sim_plan`` launch over every page and one ``sim_gather``
launch for the pages that matched — on the card, or as the kernels'
plain PyTorch versions with ``device="cpu"``.

Run:  PYTHONPATH=src python -m repro_torch.range_query_analytics [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.backend import make_backend
from repro_torch.core.bitweaving import Column, RowCodec
from repro_torch.core.engine import SimChipArray
from repro_torch.core.range_query import approximate_range, exact_range
from repro_torch.device import resolve_device
from repro_torch.index.secondary import SimSecondaryIndex


def main(device=None) -> dict:
    """Run the three parts; return every number printed: rows and pages
    loaded, the point select's rows and I/O bytes, each range plan's
    passes, rows, truth and I/O bytes, and the false-positive sweep; and
    the backend's kernel launches (two a select)."""
    device = resolve_device(device)
    rng = np.random.default_rng(1)
    codec = RowCodec([Column("gender", 1), Column("age", 7),
                      Column("salary", 20), Column("uid", 32)])
    n = 20_000
    rows = {"gender": rng.integers(0, 2, n),
            "age": rng.integers(18, 96, n),
            "salary": rng.integers(0, 200_000, n),
            "uid": np.arange(n)}
    si = SimSecondaryIndex(make_backend(
        "batched", SimChipArray(n_chips=8, pages_per_chip=64),
        device=device), codec)
    si.load_rows(rows)
    print(f"loaded {n} rows into {si.n_pages} SiM pages ({device})")
    out = {"rows": n, "pages": si.n_pages}

    print("\n=== Fig 9: point predicate (gender == 1) ===")
    got = si.select_equals("gender", 1)
    print(f"-> {len(got)} rows with one masked search per page "
          f"({si.io_bitmap_bytes} B of bitmaps, {si.io_chunk_bytes} B of "
          f"chunks)")
    out["point"] = {"rows": len(got), "bitmap_bytes": si.io_bitmap_bytes,
                    "chunk_bytes": si.io_chunk_bytes}

    print("\n=== Fig 10: 2000 < salary < 7000 ===")
    truth = int(((rows['salary'] > 2000) & (rows['salary'] < 7000)).sum())
    for exact in (True, False):
        si.io_bitmap_bytes = si.io_chunk_bytes = 0
        got = si.select_range("salary", 2001, 7000, exact=exact)
        plan = codec.range("salary", 2001, 7000, exact=exact)
        tag = "exact " if exact else "approx"
        io = si.io_bitmap_bytes + si.io_chunk_bytes
        print(f"{tag}: {plan.n_passes:2d} passes -> {len(got)} rows "
              f"(truth {truth}), I/O {io:,} B")
        out[tag.strip()] = {"passes": plan.n_passes, "rows": len(got),
                            "truth": truth, "io_bytes": io}

    print("\n=== approximate-plan error rate vs span (paper: low for "
          "uniform keys) ===")
    out["fp_sweep"] = []
    for lo, hi in [(1 << 12, 1 << 14), (5000, 6000), (100_000, 163_840)]:
        ap = approximate_range(lo, hi, width=20)
        ex = exact_range(lo, hi, width=20)
        ks = rng.integers(0, 1 << 20, size=100_000).astype(np.uint64)
        fp = int(ap.evaluate(ks).sum() - ex.evaluate(ks).sum())
        tp = int(ex.evaluate(ks).sum())
        print(f"[{lo:>7}, {hi:>7}): approx {ap.n_passes} passes, "
              f"exact {ex.n_passes} passes, false-positive rate "
              f"{fp / max(tp, 1):.2f}")
        out["fp_sweep"].append({"lo": lo, "hi": hi,
                                "approx_passes": ap.n_passes,
                                "exact_passes": ex.n_passes,
                                "fp_rate": fp / max(tp, 1)})
    out["kernel_launches"] = si.backend.stats.kernel_launches
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    main(ap.parse_args().device)
