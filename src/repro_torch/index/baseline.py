"""CPU-centric baseline index (paper §VI-A3): full-page reads + host search.

Functionally equivalent to the SiM indexes — used by tests to prove result
equality and by benchmarks to count the I/O both architectures move.
"""
from __future__ import annotations

import bisect

import numpy as np

from repro_torch.core.engine import SimChipArray
from repro_torch.core.page import entries_from_plain

LEAF_CAPACITY = 504


class BaselineBTree:
    """Same layout as SimBTree but lookups read entire pages."""

    def __init__(self, chips: SimChipArray, *, leaf_fill: int = 404):
        self.chips = chips
        self.leaf_fill = min(leaf_fill, LEAF_CAPACITY)
        self.leaves: list[tuple[int, int, int, int]] = []  # kp, vp, n, low
        self._separators: list[int] = []
        self._next_page = 0
        self.pages_read = 0
        self.bytes_read = 0

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        order = np.argsort(keys, kind="stable")
        keys, values = keys[order], values[order]
        for start in range(0, len(keys), self.leaf_fill):
            k = keys[start:start + self.leaf_fill]
            v = values[start:start + self.leaf_fill]
            kp, vp = self._next_page, self._next_page + 1
            self._next_page += 2
            self.chips.program_entries(kp, k)
            self.chips.program_entries(vp, v)
            self.leaves.append((kp, vp, len(k), int(k[0])))
            self._separators.append(int(k[0]))

    def _read_entries(self, page: int, n: int) -> np.ndarray:
        plain = self.chips.read_full(page).plain
        self.pages_read += 1
        self.bytes_read += 4096
        return entries_from_plain(plain, n)

    def lookup(self, key: int) -> int | None:
        i = bisect.bisect_right(self._separators, int(key)) - 1
        if i < 0:
            return None
        kp, vp, n, _ = self.leaves[i]
        keys = self._read_entries(kp, n)           # full 4 KiB page
        pos = np.searchsorted(keys, np.uint64(key))
        if pos >= n or keys[pos] != np.uint64(key):
            return None
        values = self._read_entries(vp, n)          # second full page
        return int(values[pos])

    def range_query(self, lo: int, hi: int) -> list[tuple[int, int]]:
        out = []
        i0 = max(bisect.bisect_right(self._separators, int(lo)) - 1, 0)
        for kp, vp, n, low in self.leaves[i0:]:
            if low >= hi:
                break
            keys = self._read_entries(kp, n)
            sel = (keys >= lo) & (keys < hi)
            if not sel.any():
                continue
            values = self._read_entries(vp, n)
            out.extend((int(k), int(v)) for k, v in zip(keys[sel],
                                                        values[sel]))
        return out
