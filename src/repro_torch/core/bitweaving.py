"""BitWeaving-style column packing into 8-byte SiM slots (paper §V-B, Fig 9/10).

Rows of a table are encoded into 64-bit keys with columns at fixed bit
ranges, ordered so that the *sort-significant* column occupies the most
significant bits (big-endian packing) — this keeps masked-prefix range tests
order-preserving, which §V-C's range decomposition relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .range_query import (MaskedQuery, RangePlan, approximate_range,
                          exact_range)

U64 = 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    width: int            # bits


class RowCodec:
    """Packs named columns into a uint64, MSB-first in declaration order."""

    def __init__(self, columns: list[Column]):
        total = sum(c.width for c in columns)
        if total > 64:
            raise ValueError(f"columns need {total} bits > 64")
        self.columns = list(columns)
        self.shifts: dict[str, int] = {}
        self.widths: dict[str, int] = {}
        pos = 64
        for c in columns:
            pos -= c.width
            self.shifts[c.name] = pos
            self.widths[c.name] = c.width
        self.spare_bits = pos   # low bits left unused (zero-filled)

    # ---------------------------------------------------------------- encode
    def encode(self, **values: int) -> int:
        key = 0
        for c in self.columns:
            v = int(values.get(c.name, 0))
            if v >> c.width:
                raise ValueError(f"{c.name}={v} exceeds {c.width} bits")
            key |= v << self.shifts[c.name]
        return key & U64

    def encode_rows(self, rows: dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(rows.values())))
        key = np.zeros(n, dtype=np.uint64)
        for c in self.columns:
            v = np.asarray(rows.get(c.name, np.zeros(n)), dtype=np.uint64)
            if ((v >> np.uint64(c.width)) != 0).any():
                raise ValueError(f"{c.name} exceeds {c.width} bits")
            key |= v << np.uint64(self.shifts[c.name])
        return key

    def decode(self, key: int, name: str) -> int:
        return (int(key) >> self.shifts[name]) & ((1 << self.widths[name]) - 1)

    def decode_rows(self, keys: np.ndarray, name: str) -> np.ndarray:
        k = np.asarray(keys, dtype=np.uint64)
        return (k >> np.uint64(self.shifts[name])) & np.uint64(
            (1 << self.widths[name]) - 1)

    # ---------------------------------------------------------------- query
    def equals(self, name: str, value: int) -> MaskedQuery:
        """Point predicate column == value -> one masked search command."""
        shift, width = self.shifts[name], self.widths[name]
        mask = ((1 << width) - 1) << shift
        return MaskedQuery(query=(int(value) << shift) & U64, mask=mask)

    def range(self, name: str, lo: int, hi: int, *,
              exact: bool = True) -> RangePlan:
        """Range predicate lo <= column < hi."""
        shift, width = self.shifts[name], self.widths[name]
        fn = exact_range if exact else approximate_range
        return fn(lo, hi, shift=shift, width=width)
