"""Deterministic fault injection for fault-enabled replays (paper §IV-C).

Two orthogonal error sources, both fully determined by a single fault seed:

  * **Stored-image errors** — retention/endurance damage to the on-flash
    (randomized) page image.  :class:`FaultModel` turns a retention age and
    P-E cycle count into a per-page raw bit-error count (a binomial draw at
    the page's raw BER) and applies it through the engine's
    ``inject_bit_errors`` + write-observer path, so the kernel backends'
    device-resident arenas see exactly the corrupted planes the scalar
    reference matches against.
  * **Transient sense noise** — per-pass comparator flips during match-mode
    sensing.  Match-mode reads cannot ECC-decode inside the latch (§IV-C),
    so this noise lands directly in the 512-bit match bitmap; the
    reliability policy suppresses it by majority voting across ``vote_k``
    repeated sense passes and by selective verification reads on hits.

Every random draw is keyed on ``(fault seed, chip seed, page, ...)`` SeedSequence
entropy, never on a shared stream, so a sweep reproduces bit-identically
across scalar/batched/sharded backends and across process restarts.

The BER growth law is the usual retention power law: the raw BER grows as
``(1 + age / retention_ref_days) ** retention_exp`` and linearly-in-log with
P-E cycling, anchored at ``base_ber``.  The reference margin matches
``EccConfig.refresh_margin_ns`` (30 days) so pages older than the refresh
margin are exactly the pages whose BER has visibly drifted.
"""
from __future__ import annotations

import dataclasses
from math import comb

import numpy as np

from repro_torch.core.bits import PAGE_BYTES, SLOTS_PER_PAGE, pack_bitmap
from repro_torch.core.page import USER_SLOTS

DAY_NS = int(24 * 3600 * 1e9)


@dataclasses.dataclass
class FaultModel:
    """Seeded per-page raw-BER model plus transient sense noise."""

    seed: int = 0
    base_ber: float = 1e-4          # raw BER at age 0, 0 P-E cycles
    retention_days: float = 0.0     # page age at replay time
    pe_cycles: int = 0
    retention_ref_days: float = 30.0   # matches EccConfig.refresh_margin_ns
    retention_exp: float = 2.5
    pe_ref_cycles: int = 3000
    pe_exp: float = 1.0
    sense_ber: float = 0.0          # per-slot comparator flip prob / pass

    def raw_ber(self) -> float:
        """Raw bit-error rate after aging/endurance scaling."""
        age = (1.0 + self.retention_days / self.retention_ref_days) \
            ** self.retention_exp
        wear = (1.0 + self.pe_cycles / self.pe_ref_cycles) ** self.pe_exp
        return min(self.base_ber * age * wear, 1.0)

    @property
    def now_ns(self) -> int:
        """Replay clock implied by the retention age (page writes are t=0)."""
        return int(self.retention_days * DAY_NS)

    def error_bits_for(self, chip_seed: int, local_addr: int) -> int:
        """Ground-truth raw error count for one page — a binomial draw at
        the page's BER, keyed on (fault seed, chip, page) only."""
        rng = np.random.default_rng(
            [self.seed, chip_seed & 0xFFFFFFFF, local_addr])
        return int(rng.binomial(PAGE_BYTES * 8, self.raw_ber()))

    def inject(self, chips) -> int:
        """Corrupt every programmed page of a SimChipArray in place.

        Flips ride ``SimChip.inject_bit_errors`` so the write observers fire
        and any device-resident arena row is invalidated — batched/sharded
        backends match against the same damaged planes as the scalar
        reference.  Returns the total number of injected error bits.
        """
        total = 0
        for chip in chips.chips:
            for local in sorted(chip.pages):
                n = self.error_bits_for(chip.device_seed, local)
                if n:
                    rng = np.random.default_rng(
                        [self.seed ^ 0x5EED, chip.device_seed & 0xFFFFFFFF,
                         local])
                    chip.inject_bit_errors(local, n, rng=rng)
                    total += n
        return total

    def slot_noise_words(self, page_addr: int, epoch: int, pass_idx: int,
                        query_hash: int) -> np.ndarray:
        """(16,) uint32 XOR mask for one match-mode sense pass.

        Each of the 512 comparator outputs flips independently with
        probability ``sense_ber``.  The draw is keyed on the page, the
        page-open epoch, the vote pass index and the query, so repeated
        sense passes of one open see *independent* noise (what voting
        averages over) while a replay of the same flush sequence — on any
        backend — sees identical noise.
        """
        if self.sense_ber <= 0.0:
            return np.zeros(16, dtype=np.uint32)
        rng = np.random.default_rng(
            [self.seed ^ 0xA11CE, page_addr, epoch, pass_idx,
             query_hash & 0xFFFFFFFF])
        flips = rng.random(SLOTS_PER_PAGE) < self.sense_ber
        return pack_bitmap(flips.astype(np.uint32))


# --------------------------------------------------------------------------
# Analytic bounds for the BER sweep (documented next to
# range_query.false_positive_bound, which bounds the *plan decomposition's*
# structural false positives; these bound the *sensing noise's*).
# --------------------------------------------------------------------------

def majority_flip_prob(p: float, k: int) -> float:
    """P[a comparator bit is flipped in the majority of k sense passes]."""
    k = max(int(k), 1)
    need = k // 2 + 1
    return float(sum(comb(k, j) * p ** j * (1.0 - p) ** (k - j)
                     for j in range(need, k + 1)))


def sense_false_positive_bound(sense_ber: float, vote_k: int = 1,
                               n_slots: int = USER_SLOTS) -> float:
    """Per-query bound: P[>= 1 spurious user slot survives voting].

    With per-slot flip probability p and k-pass majority voting, a
    non-matching slot reads as a hit with probability q = majority_flip
    (p, k); a union bound over the page's user slots gives
    ``1 - (1 - q) ** n_slots``.  Unverified match results violate this
    bound with probability 0 — the sweep asserts the measured rate under it.
    """
    q = majority_flip_prob(sense_ber, vote_k)
    return 1.0 - (1.0 - q) ** n_slots


def sense_false_negative_bound(sense_ber: float, vote_k: int = 1) -> float:
    """Per-hit bound: P[a genuinely matching slot is voted out]."""
    return majority_flip_prob(sense_ber, vote_k)
