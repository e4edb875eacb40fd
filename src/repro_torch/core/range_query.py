"""Range-query decomposition onto masked equality tests (paper §V-C).

SiM hardware only does masked equality.  The paper decomposes a range
``L <= k < U`` into:

  * an *approximate* one-pass form — round the upper bound up to the next
    power of two and test that the high prefix bits are zero (plus the
    complemented lower-bound test); result is a superset of the true range;
  * an *exact* multi-pass form, sketched as "masking out the
    previously-compared MSB region and recursively comparing" — which is the
    classic trie/prefix decomposition: any [L, U) splits into at most
    2*width - 2 prefix-aligned blocks, each testable with one masked
    equality.  We implement both.

Fields (columns BitWeaving-packed into the 64-bit key, §V-B) are handled by
shifting the decomposition into the field's bit range.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np

from .commands import Command

if TYPE_CHECKING:                                    # avoid core -> backend cycle
    from repro_torch.backend.base import MatchBackend

U64 = 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MaskedQuery:
    """One search command operand pair: compare (key & mask) == (query & mask)."""
    query: int
    mask: int

    def matches(self, keys: np.ndarray) -> np.ndarray:
        k = np.asarray(keys, dtype=np.uint64)
        return (k & np.uint64(self.mask)) == np.uint64(self.query & self.mask)


@dataclasses.dataclass(frozen=True)
class RangePlan:
    """Evaluation plan: OR over ``include``, minus OR over ``exclude``.

    The approximate plan uses include=[upper-bound test] and
    exclude=[below-lower-bound test] (bitmap AND-NOT, paper Fig 10); the
    exact plan uses include-only prefix blocks.
    """
    include: tuple[MaskedQuery, ...]
    exclude: tuple[MaskedQuery, ...] = ()
    exact: bool = True

    @property
    def n_passes(self) -> int:
        return len(self.include) + len(self.exclude)

    def evaluate(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        inc = np.zeros(keys.shape, dtype=bool)
        for q in self.include:
            inc |= q.matches(keys)
        for q in self.exclude:
            inc &= ~q.matches(keys)
        return inc


def evaluate_plan_on_pages(backend: "MatchBackend", plan: RangePlan,
                           page_addrs: Sequence[int]) -> np.ndarray:
    """Run a RangePlan over many pages through a MatchBackend.

    ONE ``Op.PLAN`` command per page, flushed together: the backend's
    fused plan path (the ``sim_plan`` kernel on the batched backend)
    accumulates OR over include
    passes and AND-NOT over exclude passes *in-latch* (paper Fig 10) and
    ships one combined 64 B bitmap per page — device->host result bytes
    shrink by the pass count versus the per-pass path
    (:func:`evaluate_plan_per_pass`).  Returns the combined
    (len(page_addrs), 16) uint32 slot bitmaps.
    """
    from repro_torch.reliability import require_clean
    tickets = [backend.submit_plan(Command.plan(p, plan.include,
                                                plan.exclude))
               for p in page_addrs]
    backend.flush()
    out = np.zeros((len(page_addrs), 16), dtype=np.uint32)
    for i, t in enumerate(tickets):
        # Propagates UncorrectableReadError from a reliability-tier backend
        # — a page that failed outer-code decode must not contribute an
        # all-zero bitmap that reads as "no keys in range".
        out[i] = require_clean(t.result()).bitmap_words
    return out


def evaluate_plan_per_pass(backend: "MatchBackend", plan: RangePlan,
                           page_addrs: Sequence[int]) -> np.ndarray:
    """The pre-PLAN split path: one SEARCH per (page, pass), one flush,
    per-pass bitmaps combined on the host.

    Kept as the bit-exactness reference for ``Op.PLAN``
    (tests/test_torch_plan.py, ``chip_smoke.py``) — this path crosses
    64 B per pass per page where PLAN crosses 64 B per page.
    """
    from repro_torch.reliability import require_clean
    include = [[backend.submit_search(Command.search(p, mq.query, mq.mask))
                for mq in plan.include] for p in page_addrs]
    exclude = [[backend.submit_search(Command.search(p, mq.query, mq.mask))
                for mq in plan.exclude] for p in page_addrs]
    backend.flush()
    out = np.zeros((len(page_addrs), 16), dtype=np.uint32)
    for i in range(len(page_addrs)):
        acc = np.zeros(16, dtype=np.uint32)
        for t in include[i]:
            acc |= require_clean(t.result()).bitmap_words
        for t in exclude[i]:
            acc &= ~require_clean(t.result()).bitmap_words
        out[i] = acc
    return out


def _field_mask(shift: int, width: int) -> int:
    return ((1 << width) - 1) << shift


def prefix_query(prefix_value: int, free_bits: int, shift: int,
                 width: int) -> MaskedQuery:
    """Equality on the top ``width - free_bits`` bits of a field."""
    mask = _field_mask(shift, width) & ~_field_mask(shift, free_bits)
    return MaskedQuery(query=(prefix_value << shift) & U64, mask=mask & U64)


def approximate_range(lo: int, hi: int, *, shift: int = 0,
                      width: int = 64) -> RangePlan:
    """Paper §V-C one-pass-per-bound superset plan for lo <= k < hi."""
    if not (0 <= lo < hi <= (1 << width)):
        raise ValueError((lo, hi, width))
    include: list[MaskedQuery] = []
    exclude: list[MaskedQuery] = []
    # Upper bound k < hi -> k <= 2^ceil(log2(hi)) - 1: high bits above
    # ceil(log2(hi)) must be zero.
    ub_bits = max(int(hi - 1).bit_length(), 0)
    if ub_bits < width:
        include.append(prefix_query(0, ub_bits, shift, width))
    else:
        include.append(MaskedQuery(query=0, mask=0))   # all keys pass
    # Lower bound k >= lo -> NOT (k < 2^floor(log2(lo)) ... ) exactly as the
    # paper: k < lo approximated by k <= 2^ceil(log2(lo))-1 using the
    # *floor* power so the excluded set is a subset (keeps superset
    # semantics of the overall plan).
    if lo > 0:
        lb_bits = int(lo).bit_length() - 1   # floor(log2(lo))
        if lb_bits >= 0:
            exclude.append(prefix_query(0, lb_bits, shift, width))
    return RangePlan(include=tuple(include), exclude=tuple(exclude),
                     exact=False)


def exact_range(lo: int, hi: int, *, shift: int = 0,
                width: int = 64) -> RangePlan:
    """Exact prefix decomposition of [lo, hi) into masked equality blocks."""
    if not (0 <= lo < hi <= (1 << width)):
        raise ValueError((lo, hi, width))
    blocks: list[MaskedQuery] = []
    cur = lo
    while cur < hi:
        s = 0
        while s < width:
            block = 1 << (s + 1)
            if (cur & (block - 1)) != 0 or cur + block > hi:
                break
            s += 1
        blocks.append(prefix_query(cur, s, shift, width))
        cur += 1 << s
    return RangePlan(include=tuple(blocks), exact=True)


def false_positive_bound(plan: RangePlan, lo: int, hi: int,
                         width: int = 64) -> float:
    """Upper bound on the superset blow-up of an approximate plan under a
    uniform key distribution (paper §V-C cites low error for uniform keys).

    This bounds the *decomposition* error only: an exact plan has zero.
    Under the reliability tier a second, independent error source exists —
    per-sense bit flips in match mode (§IV-C3) — whose per-page
    false-positive probability is bounded analytically by
    the reliability tier's ``sense_false_positive_bound`` (and driven to
    ~zero by k-pass voting + selective hit verification; the
    ``reliability_sweep`` benchmark of the JAX package measures both).
    """
    if plan.exact:
        return 0.0
    ub_bits = max(int(hi - 1).bit_length(), 0)
    lb_bits = int(lo).bit_length() - 1 if lo > 0 else 0
    covered = (1 << ub_bits) - (1 << lb_bits if lo > 0 else 0)
    true_span = hi - lo
    return covered / true_span - 1.0
