"""Traffic kind ``ycsb``: the frozen YCSB stream (``yardstick/ycsb.py``) of
``stream_ops`` ops, its first ``warmup_ops`` run at set-up, followed by a
tail of ``readback_keys`` reads of the first keys the stream updates (read
back once the window has closed: the warm-up's updates always ran, so every
run checks acknowledged writes)."""
from __future__ import annotations

import dataclasses

import numpy as np

from simbench.yardstick import ycsb


@dataclasses.dataclass
class KvInputs:
    ops: np.ndarray          # (N + R,) uint8: the stream, then R reads
    keys: np.ndarray         # (N + R,) int64
    key_pages: np.ndarray
    value_pages: np.ndarray
    scan_lens: np.ndarray | None
    alpha: float
    read_ratio: float
    n_stream: int            # N: ops the window may draw from
    warmup: int              # the first ops, run at set-up
    readback: np.ndarray     # indices of the tail reads


def make(config: dict, traffic: dict, seed: int) -> KvInputs:
    n = int(traffic["stream_ops"])
    s = ycsb.generate(n, n_key_pages=int(config["n_key_pages"]),
                      read_ratio=float(traffic["read"]),
                      alpha=float(traffic["zipf"]), seed=seed,
                      scan_ratio=float(traffic["scan"]),
                      max_scan_len=int(traffic["max_scan_len"]))
    warm = min(int(traffic["warmup_ops"]), n)
    updated = s.keys[s.ops == 1]
    _, first = np.unique(updated, return_index=True)
    back = updated[np.sort(first)][:int(traffic["readback_keys"])]
    r = back.size
    key_pages = (back // ycsb.KEYS_PER_PAGE).astype(np.int32)
    scan_lens = (None if s.scan_lens is None else
                 np.concatenate([s.scan_lens, np.zeros(r, np.int32)]))
    return KvInputs(
        ops=np.concatenate([s.ops, np.zeros(r, np.uint8)]),
        keys=np.concatenate([s.keys, back.astype(np.int64)]),
        key_pages=np.concatenate([s.key_pages, key_pages]),
        value_pages=np.concatenate([
            s.value_pages, ycsb.value_page_of(
                key_pages, s.n_key_pages).astype(np.int32)]),
        scan_lens=scan_lens, alpha=s.alpha, read_ratio=s.read_ratio,
        n_stream=n, warmup=warm, readback=np.arange(n, n + r))
