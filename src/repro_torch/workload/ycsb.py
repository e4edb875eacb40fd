"""YCSB-like workload generation (paper §VI-A4/A5).

Key popularity follows a (scrambled) Zipf over key ranks with parameter
alpha in {0 (uniform), 0.5 (skewed), 0.9 (very skewed)}; read ratio and
cache-coverage grids mirror the paper's figures.  Keys map to (key page,
value page) pairs of the generic index of Fig 11: 504 keys per 4 KiB page,
key and value pages disjoint halves of the page space.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KEYS_PER_PAGE = 504


def value_page_of(key_page, n_key_pages: int):
    """§V-A leaf placement: value page of key page i, second half of the
    address space rotated by one so the pair lands on two different dies."""
    return n_key_pages + (key_page + 1) % n_key_pages


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    if alpha <= 0.0:
        return np.full(n, 1.0 / n)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def concentration_table(n: int, alpha: float, top: int = 4) -> np.ndarray:
    """Fraction of queries landing on the top-k keys (paper Table III)."""
    return zipf_probs(n, alpha)[:top]


@dataclasses.dataclass
class Workload:
    ops: np.ndarray          # (N,) uint8: 0 = read, 1 = write, 2 = scan
    key_pages: np.ndarray    # (N,) int32
    value_pages: np.ndarray  # (N,) int32
    alpha: float
    read_ratio: float
    n_index_pages: int
    # Concrete key ids (rank-scrambled), one per op — lets the functional
    # executor (repro_torch.frontend.replay) replay the stream against real pages.
    keys: np.ndarray | None = None
    # YCSB-E: scan lengths, one per op (used where ops == 2).  A scan
    # starting at key k covers [k, k + len) and replays as ONE Op.PLAN
    # range plan per key page through the backend's fused in-latch path.
    scan_lens: np.ndarray | None = None


def generate(n_queries: int, *, n_key_pages: int, read_ratio: float,
             alpha: float, seed: int = 0, scramble: bool = True,
             scan_ratio: float = 0.0, max_scan_len: int = 64) -> Workload:
    """Generate a closed-loop query stream.

    ``n_key_pages`` pages of keys; each key page i pairs with value page
    ``n_key_pages + i`` (the §V-A two-page leaf layout).  With ``scramble``
    the popularity ranks are permuted across the keyspace so rank-adjacent
    hot keys do not collapse onto one page (YCSB's scrambled zipfian).
    ``scan_ratio`` carves YCSB-E range scans (op 2, uniform lengths in
    [1, max_scan_len]) out of the top of the op-probability space; the
    default 0 leaves the historical read/write stream bit-identical.
    """
    if scan_ratio > 0.0 and read_ratio + scan_ratio > 1.0:
        # Scans carve the top of the probability space [1-scan_ratio, 1),
        # which must fit inside the write band [read_ratio, 1) — otherwise
        # scans would silently swallow the requested writes (and reads).
        raise ValueError(f"read_ratio {read_ratio} + scan_ratio "
                         f"{scan_ratio} > 1: no probability mass left "
                         "for the write band")
    rng = np.random.default_rng(seed)
    n_keys = n_key_pages * KEYS_PER_PAGE
    probs = zipf_probs(n_keys, alpha)
    ranks = rng.choice(n_keys, size=n_queries, p=probs)
    if scramble:
        perm = rng.permutation(n_keys)
        keys = perm[ranks]
    else:
        keys = ranks
    key_pages = (keys // KEYS_PER_PAGE).astype(np.int32)
    # The rotated pairing keeps both page buffers latched for hot leaves and
    # makes the chip-internal search->gather pipelining effective.
    value_pages = value_page_of(key_pages, n_key_pages)
    r = rng.random(n_queries)
    ops = (r >= read_ratio).astype(np.uint8)
    scan_lens = None
    if scan_ratio > 0.0:
        ops[r >= 1.0 - scan_ratio] = 2
        scan_lens = rng.integers(1, max_scan_len + 1, n_queries,
                                 dtype=np.int32)
    return Workload(ops=ops, key_pages=key_pages,
                    value_pages=value_pages.astype(np.int32), alpha=alpha,
                    read_ratio=read_ratio, n_index_pages=2 * n_key_pages,
                    keys=keys.astype(np.int64), scan_lens=scan_lens)
