"""Time the row CRC's two position-table passes against each other.

    python3 scripts/crc_crossover.py [--widths 64 56] [--seconds 0.05]

For each row width and row count, times ``crc32_rows`` and ``crc64_rows``
forced into the one-gather pass and into the column loop (by setting
``core/ecc._GATHER_MAX_BYTES`` either way), and the byte-position loop the
tables replaced (``ecc._crc_rows_loop``), each the best of 5 repeats of
about ``--seconds``.  Prints a JSON line per row count (microseconds a
call), then one with the smallest row count from which on the column loop
beat the gather at every larger count, the two CRCs' times summed, and its
row bytes: the figure ``_GATHER_MAX_BYTES`` is set from.  Runs on the
host's CPU only; writes the lines under ``chiprun_out/crc_crossover.jsonl``
too.
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import numpy as np  # noqa: E402

from repro_torch.core import ecc  # noqa: E402

ROWS = (1, 4, 20, 64, 256, 512, 768, 1024, 1280, 1536, 2048, 3072, 4096,
        8192, 16384, 65536)
PASSES = {"crc32": (ecc.crc32_rows, ecc._CRC32_TABLE),
          "crc64": (ecc.crc64_rows, ecc._CRC64_TABLE)}


def best_us(fn, rows, seconds: float) -> float:
    fn(rows)
    t0 = time.perf_counter()
    fn(rows)
    reps = max(1, int(seconds / max(time.perf_counter() - t0, 1e-7)))
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(rows)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e6


def forced(fn, limit):
    def run(rows):
        saved, ecc._GATHER_MAX_BYTES = ecc._GATHER_MAX_BYTES, limit
        try:
            return fn(rows)
        finally:
            ecc._GATHER_MAX_BYTES = saved
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[64, 56])
    ap.add_argument("--seconds", type=float, default=0.05)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    lines = [{"host": platform.processor() or platform.machine(),
              "numpy": np.__version__,
              "gather_max_bytes": ecc._GATHER_MAX_BYTES}]
    for width in args.widths:
        wins = []
        for k in ROWS:
            rows = rng.integers(0, 256, (k, width)).astype(np.uint8)
            line = {"width": width, "rows": k, "row_bytes": k * width}
            for name, (fn, table) in PASSES.items():
                gather, columns = forced(fn, 1 << 62), forced(fn, -1)
                assert np.array_equal(gather(rows), columns(rows))
                line[name] = {
                    "gather_us": best_us(gather, rows, args.seconds),
                    "columns_us": best_us(columns, rows, args.seconds),
                    "loop_us": best_us(
                        lambda r: ecc._crc_rows_loop(r, table), rows,
                        args.seconds)}
            wins.append(sum(line[n]["columns_us"] - line[n]["gather_us"]
                            for n in PASSES) < 0)
            lines.append(line)
            print(json.dumps(line), flush=True)
        first = None
        for k, win in zip(reversed(ROWS), reversed(wins)):
            if not win:
                break
            first = k
        lines.append({"width": width, "columns_win_from_rows": first,
                      "columns_win_from_row_bytes": (None if first is None
                                                     else first * width)})
        print(json.dumps(lines[-1]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "crc_crossover.jsonl", "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
