"""Plain NumPy reference of the ``kv`` configurations, and their control.

Serial semantics over the ops a run executed, in the order it executed
them: key id ``k`` starts at ``((k + 1) * 0x9E3779B97F4A7C15) | 1`` (mod
2**64), an update at op index ``i`` writes ``2 * i + 1``, a read returns the
latest value of its key, and a scan of ``len`` ids from ``k`` counts the
stored keys ``k + 1 .. k + len`` that exist (ids below the key count).  It
imports nothing of the program: it reads the generated inputs, and the
program's answers only to judge them.
"""
from __future__ import annotations

import numpy as np

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
KEYS_PER_PAGE = 504


def expected(config: dict, inputs, order: np.ndarray, *,
             lost_writes: bool = False, first_page_scans: bool = False):
    """Read values and scan counts by op index.  The controls:
    ``lost_writes``, updates are acknowledged but never reach the store;
    ``first_page_scans``, a scan counts only the keys on the first page it
    touches (a plan flush that drops the scan's later pages)."""
    n_keys = int(config["n_key_pages"]) * KEYS_PER_PAGE
    values = (np.arange(1, n_keys + 1, dtype=np.uint64) * GOLDEN) \
        | np.uint64(1)
    n = len(inputs.ops)
    want = np.zeros(n, np.uint64)
    counts = np.zeros(n, np.int64)
    ops, keys = inputs.ops, inputs.keys
    for qi in order.tolist():
        op, k = int(ops[qi]), int(keys[qi])
        if op == 0:
            want[qi] = values[k]
        elif op == 1:
            if not lost_writes:
                values[k] = np.uint64(2 * qi + 1)
        else:
            hi = min(k + 1 + int(inputs.scan_lens[qi]), n_keys + 1)
            if first_page_scans:            # stored keys of page k // 504
                hi = min(hi, (k // KEYS_PER_PAGE + 1) * KEYS_PER_PAGE + 1)
            counts[qi] = hi - (k + 1)
    return want, counts


def order_of(executed: dict) -> np.ndarray:
    return np.concatenate([executed["warmup"], executed["window"],
                           executed["tail"]]).astype(np.int64)


def _control(**broken):
    def answers(config: dict, inputs, executed: dict) -> dict:
        want, counts = expected(config, inputs, order_of(executed),
                                **broken)
        return {"out": want, "hits": np.ones(len(want), bool),
                "scan_counts": counts}
    return answers


def _has_scans(inputs, executed) -> bool:
    return bool((inputs.ops[order_of(executed)] == 2).any())


# The controls: the reference in the program's place with one guarantee of
# the configuration broken, each with the test of whether the run has the
# answers it breaks.
CONTROLS = {
    # a store that acknowledges every update and loses it
    "lost_writes": (_control(lost_writes=True), lambda inputs, ex: True),
    # scans that count the keys of their first page only
    "first_page_scans": (_control(first_page_scans=True), _has_scans),
}


def check(config: dict, inputs, executed: dict, got: dict):
    """Compared numbers ``{name: (value, limit)}``, the window's ops whose
    answer is wrong, and how many answers of each kind were compared."""
    order = order_of(executed)
    want, counts = expected(config, inputs, order)
    ops = inputs.ops
    bad = np.zeros(len(ops), bool)
    reads = order[ops[order] == 0]
    bad[reads] = (got["out"][reads] != want[reads]) | ~got["hits"][reads]
    scans = order[ops[order] == 2]
    bad[scans] = got["scan_counts"][scans] != counts[scans]
    tail = np.asarray(executed["tail"], np.int64)
    stream_reads = reads[~np.isin(reads, tail)]
    compared = {"reads": int(stream_reads.size), "readbacks": int(tail.size),
                "scans": int(scans.size)}
    # A number is compared only where the run has answers of its kind.
    numbers = {f"{name}_mismatches": (int(bad[idx].sum()), 0)
               for name, idx in (("read", stream_reads), ("readback", tail),
                                 ("scan", scans)) if idx.size}
    return numbers, int(bad[executed["window"]].sum()), compared
