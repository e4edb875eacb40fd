"""Frozen copy of the YCSB stream generator the port's replays are fed.

The same draws as ``repro_torch.workload.ycsb.generate`` at the time the
benchmark was defined, so that a change to the program's generator cannot
change the benchmark's traffic.  Key popularity is a Zipf over key ranks,
scrambled across the key space by a seeded permutation (so hot ranks do
not collapse onto one page); each key page ``i`` pairs with the value page
``n_key_pages + (i + 1) % n_key_pages`` (the paper's §V-A leaf layout).
Op codes: 0 read, 1 update, 2 scan.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KEYS_PER_PAGE = 504


def value_page_of(key_page, n_key_pages: int):
    return n_key_pages + (key_page + 1) % n_key_pages


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    if alpha <= 0.0:
        return np.full(n, 1.0 / n)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


@dataclasses.dataclass
class Stream:
    ops: np.ndarray          # (N,) uint8
    keys: np.ndarray         # (N,) int64 key ids
    key_pages: np.ndarray    # (N,) int32
    value_pages: np.ndarray  # (N,) int32
    scan_lens: np.ndarray | None
    alpha: float
    read_ratio: float
    n_key_pages: int


def generate(n_queries: int, *, n_key_pages: int, read_ratio: float,
             alpha: float, seed: int = 0, scan_ratio: float = 0.0,
             max_scan_len: int = 64) -> Stream:
    """``scan_ratio`` carves scans (uniform lengths in [1, max_scan_len])
    out of the top of the op-probability space; the updates are the band
    between ``read_ratio`` and ``1 - scan_ratio``."""
    if scan_ratio > 0.0 and read_ratio + scan_ratio > 1.0:
        raise ValueError(f"read_ratio {read_ratio} + scan_ratio "
                         f"{scan_ratio} > 1")
    rng = np.random.default_rng(seed)
    n_keys = n_key_pages * KEYS_PER_PAGE
    probs = zipf_probs(n_keys, alpha)
    ranks = rng.choice(n_keys, size=n_queries, p=probs)
    perm = rng.permutation(n_keys)
    keys = perm[ranks]
    key_pages = (keys // KEYS_PER_PAGE).astype(np.int32)
    value_pages = value_page_of(key_pages, n_key_pages)
    r = rng.random(n_queries)
    ops = (r >= read_ratio).astype(np.uint8)
    scan_lens = None
    if scan_ratio > 0.0:
        ops[r >= 1.0 - scan_ratio] = 2
        scan_lens = rng.integers(1, max_scan_len + 1, n_queries,
                                 dtype=np.int32)
    return Stream(ops=ops, keys=keys.astype(np.int64), key_pages=key_pages,
                  value_pages=value_pages.astype(np.int32),
                  scan_lens=scan_lens, alpha=alpha, read_ratio=read_ratio,
                  n_key_pages=n_key_pages)
