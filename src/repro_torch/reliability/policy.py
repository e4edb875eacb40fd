"""ECC-aware match execution: the reliability tier behind every backend.

Match-mode reads cannot ECC-decode inside the latch (paper §IV-C), so a
fault-enabled replay wraps every search/plan/lookup burst in the §IV-C2/C3
machinery:

  * **Open burst** — once per flush, every touched page runs
    ``optimistic_open`` against its *current* (possibly damaged) header:
    CLEAN proceeds on the fast path, FALLBACK_ECC charges a full-page
    storage-mode read (and repairs the stored image through the write
    observers, so kernel arenas restage the corrected plane in the same
    flush), CLEAN_NEEDS_REFRESH queues the page for a refresh rewrite, and
    UNCORRECTABLE fails the page's tickets with a typed
    :class:`UncorrectableReadError` instead of returning a wrong bitmap.
  * **Voting** — the raw match bitmap is re-sensed ``vote_k`` times under
    independent transient noise and majority-voted, suppressing comparator
    false positives/negatives before any bus transfer.
  * **Selective verification** — only the chunks holding match *hits* are
    re-read and checked against their inner CRC-32 parities
    (``verify_chunks``); a parity mismatch escalates to the full-page
    outer-code fallback.  Verified hit chunks are replaced by an exact
    host-side recompute, so every surviving hit equals the oracle's.

The finalize steps are *chunk-wise idempotent*: a verified hit chunk's bits
equal the clean image's bits whether the page was repaired before, during,
or after this command's resolution, so scalar (eager, submission-order
resolve) and the kernel backends (lazy, phase-order resolve) produce
bit-identical bitmaps, values, and error outcomes under one fault seed.
Reliability traffic is accounted in :class:`ReliabilityStats` (and, for the
sharded backend, on the flash timelines) — never in ``BackendStats``, whose
staged/result byte counters keep counting only the launches' own traffic.
The kernels are the unchanged search, lookup, gather and plan launches;
everything here runs on the host around them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import ecc
from repro_torch.core.bits import (SLOTS_PER_CHUNK, SLOTS_PER_PAGE,
                                   pack_bitmap, popcount_words,
                                   unpack_bitmap)
from repro_torch.core.commands import (Command, GatherResponse,
                                       LookupResponse, SearchResponse)
from repro_torch.core.ecc import EccConfig, OpenVerdict, optimistic_open
from repro_torch.core.page import mask_header_slots, page_slot_words
from repro_torch.core.randomize import randomize_query

from .errors import UncorrectableReadError
from .faults import FaultModel


@dataclasses.dataclass
class ReliabilityPolicy:
    """Knobs of the §IV-C2/C3 pipeline (see README "Reliability tier")."""

    ecc: EccConfig = dataclasses.field(default_factory=EccConfig)
    verify_hits: bool = True      # chunk-parity verification reads on hits
    fallback_on_miss: bool = True  # full-page fallback when a LOOKUP misses
    vote_k: int = 1               # sense passes for majority voting


@dataclasses.dataclass
class ReliabilityStats:
    opens: int = 0              # optimistic page opens performed
    clean_opens: int = 0
    retries: int = 0            # sensing-voltage read-retries
    fallbacks: int = 0          # open-time full-page ECC fallbacks
    uncorrectable: int = 0      # outer-code decode failures (typed errors)
    corrected_bits: int = 0
    refresh_marked: int = 0     # distinct pages queued for refresh
    refreshes: int = 0          # refresh rewrites executed (runner drains)
    vote_passes: int = 0        # extra sense passes charged by voting
    verify_reads: int = 0       # selective hit-chunk verification reads
    verify_failures: int = 0    # inner-parity mismatches found by them
    fallback_reads: int = 0     # full-page storage-mode reads (open+resolve)
    miss_fallbacks: int = 0     # lookup misses escalated to a full read
    wrong_value_parity: int = 0  # corrupted value chunks served unverified


@dataclasses.dataclass
class PageOpen:
    """One page's open outcome within a flush, captured into the flush's
    resolve closures (state dicts move on — the next flush may re-open the
    page before this flush's lazy tails run)."""

    result: ecc.OpenResult
    epoch: int                  # open sequence number, keys the sense noise

    @property
    def verdict(self) -> OpenVerdict:
        return self.result.verdict


def match_bitmap(chip, local_addr: int, query, mask) -> np.ndarray:
    """Noise-free host recompute of one masked-equality search against the
    chip's *current* stored image — the bits a full-page storage-mode read
    plus controller-side compare would produce (the §IV-C3 verified path).
    No latch or counter side effects."""
    sp = chip.pages[local_addr]
    words = page_slot_words(sp.raw)
    q = randomize_query(np.array(query, dtype=np.uint32), local_addr,
                        chip.device_seed)
    mk = np.array(mask, dtype=np.uint32)
    mismatch = ((words[:, 0] ^ q[:, 0]) & mk[0]) | (
        (words[:, 1] ^ q[:, 1]) & mk[1])
    return pack_bitmap((mismatch == 0).astype(np.uint32))


def plan_bitmap(chip, local_addr: int, plan_include, plan_exclude
                ) -> np.ndarray:
    """Host recompute of a multi-pass plan (OR includes, AND-NOT excludes)."""
    acc = np.zeros(16, dtype=np.uint32)
    for q, mk in plan_include:
        acc |= match_bitmap(chip, local_addr, q, mk)
    for q, mk in plan_exclude or ():
        acc &= ~match_bitmap(chip, local_addr, q, mk)
    return acc


def _mix_ints(*vals: int) -> int:
    h = 0x811C9DC5
    for v in vals:
        h = ((h * 1000003) ^ (int(v) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return h


def _search_hash(cmd: Command) -> int:
    return _mix_ints(*cmd.query, *cmd.mask)


def _plan_hash(cmd: Command) -> int:
    flat: list[int] = [len(cmd.plan_include), len(cmd.plan_exclude or ())]
    for q, mk in list(cmd.plan_include) + list(cmd.plan_exclude or ()):
        flat += [*q, *mk]
    return _mix_ints(*flat)


class ReliabilityState:
    """Per-replay reliability context shared by a backend's flushes.

    Holds the policy, the fault model, the running stats, the refresh queue
    and the per-page open-epoch counters.  One instance is attached to one
    backend via ``MatchBackend.enable_reliability`` (usually through
    ``replay(..., RunConfig.reliable(...))``).
    """

    def __init__(self, policy: ReliabilityPolicy | None = None,
                 fault_model: FaultModel | None = None, *,
                 seed: int = 0, now_ns: int | None = None):
        self.policy = policy or ReliabilityPolicy()
        self.fault_model = fault_model
        self.seed = seed if fault_model is None else fault_model.seed
        self.now_ns = now_ns if now_ns is not None else (
            fault_model.now_ns if fault_model is not None else 0)
        self.stats = ReliabilityStats()
        self.refresh_due: set[int] = set()
        self._epochs: dict[int, int] = {}

    def install(self, backend) -> int:
        """Attach to a backend and corrupt its stored pages per the fault
        model.  Returns the number of injected error bits."""
        backend.enable_reliability(self)
        if self.fault_model is not None:
            return self.fault_model.inject(backend.chips)
        return 0

    @property
    def vote_factor(self) -> int:
        """Sense/match multiplier voting imposes on the timeline (1 when
        there is no transient noise to vote over)."""
        fm = self.fault_model
        if fm is None or fm.sense_ber <= 0.0:
            return 1
        return max(self.policy.vote_k, 1)

    # ----------------------------------------------------------- open burst
    def open_burst(self, chips, page_addrs) -> dict[int, PageOpen]:
        """Optimistically open every unique page a flush touches.

        Runs *before* the kernel backends stage plane rows, so an open-time
        ECC fallback repairs the stored image and the same flush's staging
        pass ships the corrected row.  Header CRCs for the whole burst are
        checked in ONE vectorized pass (``parse_header_chunks``).  Retry
        randomness is keyed per (fault seed, chip, page, open epoch) — the
        satellite fix to the shared-default-generator degeneracy.
        """
        addrs = sorted({int(a) for a in page_addrs})
        if not addrs:
            return {}
        routed = []
        header_chunks = []
        for a in addrs:
            chip, local = chips.route(a)
            sp = chip.pages[local]
            routed.append((a, chip, local, sp))
            header_chunks.append(chip._derandomized_chunk(sp, local, 0))
        headers = ecc.parse_header_chunks(np.stack(header_chunks))
        out: dict[int, PageOpen] = {}
        for (a, chip, local, sp), header in zip(routed, headers):
            epoch = self._epochs.get(a, 0)
            self._epochs[a] = epoch + 1
            rng = np.random.default_rng(
                [self.seed, chip.device_seed & 0xFFFFFFFF, local, epoch])
            res = optimistic_open(
                None, now_ns=self.now_ns,
                injected_error_bits=sp.injected_error_bits,
                cfg=self.policy.ecc, rng=rng, header=header)
            self.stats.opens += 1
            self.stats.retries += res.retries_used
            if res.verdict is OpenVerdict.CLEAN:
                self.stats.clean_opens += 1
            elif res.verdict is OpenVerdict.CLEAN_NEEDS_REFRESH:
                if a not in self.refresh_due:
                    self.refresh_due.add(a)
                    self.stats.refresh_marked += 1
                chip.counters.open_refreshes += 1
            elif res.verdict is OpenVerdict.FALLBACK_ECC:
                self.stats.fallbacks += 1
                self.stats.fallback_reads += 1
                self.stats.corrected_bits += res.bits_corrected
                chip.counters.open_fallbacks += 1
                chip._repair(sp, local)
            else:  # UNCORRECTABLE — leave damaged; tickets fail typed
                self.stats.uncorrectable += 1
                chip.counters.open_fallbacks += 1
            out[a] = PageOpen(res, epoch)
        return out

    # ------------------------------------------------------- finalize paths
    def _vote(self, page_addr: int, epoch: int, query_hash: int,
              bitmap: np.ndarray) -> np.ndarray:
        """Majority-vote the raw bitmap across vote_k noisy sense passes."""
        fm = self.fault_model
        if fm is None or fm.sense_ber <= 0.0:
            return bitmap
        k = max(self.policy.vote_k, 1)
        votes = np.zeros(SLOTS_PER_PAGE, dtype=np.int32)
        for j in range(k):
            noisy = bitmap ^ fm.slot_noise_words(page_addr, epoch, j,
                                                 query_hash)
            votes += unpack_bitmap(noisy, SLOTS_PER_PAGE)
        self.stats.vote_passes += k - 1
        return pack_bitmap((votes * 2 > k).astype(np.uint32))

    def _resolve_fallback(self, chips, page_addr: int) -> None:
        """Full-page storage-mode read + outer decode at resolve time
        (verification failure or lookup-miss escalation)."""
        chip, local = chips.route(page_addr)
        sp = chip.pages[local]
        self.stats.fallback_reads += 1
        chip.counters.array_reads += 1
        chip.counters.full_reads += 1
        if sp.injected_error_bits == 0:
            return
        if sp.injected_error_bits <= self.policy.ecc.t_correctable:
            self.stats.corrected_bits += sp.injected_error_bits
            chip._repair(sp, local)
        else:
            self.stats.uncorrectable += 1
            raise UncorrectableReadError(page_addr)

    def _verify_hits(self, chips, page_addr: int, bitmap: np.ndarray,
                     recompute) -> np.ndarray:
        """Selective verification (§IV-C3): re-read only the chunks holding
        hits, check inner parities, and replace their bits with the exact
        host recompute.  A parity mismatch escalates to the full-page
        fallback (repairing the page, or raising when above budget)."""
        hits = unpack_bitmap(mask_header_slots(bitmap), SLOTS_PER_PAGE)
        hit_chunks = np.unique(np.nonzero(hits)[0] // SLOTS_PER_CHUNK)
        if hit_chunks.size == 0:
            return bitmap
        chip, local = chips.route(page_addr)
        sp = chip.pages[local]
        self.stats.verify_reads += int(hit_chunks.size)
        chip.counters.chunks_gathered += int(hit_chunks.size)
        ok = ecc.verify_chunks(chip._derandomize_page(sp, local),
                               sp.chunk_parities, hit_chunks)
        if not ok.all():
            self.stats.verify_failures += int((~ok).sum())
            self._resolve_fallback(chips, page_addr)
        true_bits = unpack_bitmap(recompute(), SLOTS_PER_PAGE)
        out = unpack_bitmap(bitmap, SLOTS_PER_PAGE).copy()
        for c in hit_chunks:
            lo = int(c) * SLOTS_PER_CHUNK
            out[lo:lo + SLOTS_PER_CHUNK] = true_bits[lo:lo + SLOTS_PER_CHUNK]
        return pack_bitmap(out)

    def _finalize_bitmap(self, chips, cmd: Command, raw_bitmap: np.ndarray,
                         opens: dict[int, PageOpen], query_hash: int,
                         recompute) -> SearchResponse:
        po = opens[cmd.page_addr]
        if po.verdict is OpenVerdict.UNCORRECTABLE:
            raise UncorrectableReadError(cmd.page_addr)
        bitmap = self._vote(cmd.page_addr, po.epoch, query_hash,
                            np.asarray(raw_bitmap, dtype=np.uint32))
        if self.policy.verify_hits:
            bitmap = self._verify_hits(chips, cmd.page_addr, bitmap,
                                       recompute)
        return SearchResponse(bitmap_words=bitmap,
                              match_count=int(popcount_words(bitmap).sum()),
                              open_verdict=po.verdict.value)

    def finalize_search(self, chips, cmd: Command, raw_bitmap,
                        opens: dict[int, PageOpen]) -> SearchResponse:
        chip, local = chips.route(cmd.page_addr)
        return self._finalize_bitmap(
            chips, cmd, raw_bitmap, opens, _search_hash(cmd),
            lambda: match_bitmap(chip, local, cmd.query, cmd.mask))

    def finalize_plan(self, chips, cmd: Command, raw_bitmap,
                      opens: dict[int, PageOpen]) -> SearchResponse:
        chip, local = chips.route(cmd.page_addr)
        return self._finalize_bitmap(
            chips, cmd, raw_bitmap, opens, _plan_hash(cmd),
            lambda: plan_bitmap(chip, local, cmd.plan_include,
                                cmd.plan_exclude))

    def finalize_lookup(self, chips, cmd: Command, raw_bitmap,
                        opens: dict[int, PageOpen]) -> LookupResponse:
        if opens[cmd.value_page].verdict is OpenVerdict.UNCORRECTABLE:
            raise UncorrectableReadError(cmd.value_page)
        search = self.finalize_search(chips, cmd, raw_bitmap, opens)
        slots = np.nonzero(unpack_bitmap(
            mask_header_slots(search.bitmap_words), SLOTS_PER_PAGE))[0]
        if slots.size == 0 and self.policy.fallback_on_miss:
            # A miss on a key page may be a sensing false negative or body
            # damage the optimistic check was blind to: escalate to the
            # full-page read before reporting the miss (lookups only —
            # zero-hit pages are legitimate for searches and plans).
            self.stats.miss_fallbacks += 1
            self._resolve_fallback(chips, cmd.page_addr)
            chip, local = chips.route(cmd.page_addr)
            bitmap = mask_header_slots(
                match_bitmap(chip, local, cmd.query, cmd.mask))
            search = SearchResponse(
                bitmap_words=bitmap,
                match_count=int(popcount_words(bitmap).sum()),
                open_verdict=search.open_verdict)
            slots = np.nonzero(unpack_bitmap(bitmap, SLOTS_PER_PAGE))[0]
        if slots.size == 0:
            return LookupResponse(search=search, value_slot=None, value=None)
        slot = int(slots[0])
        value, parity = self._read_value(chips, cmd.value_page, slot)
        return LookupResponse(search=search, value_slot=slot, value=value,
                              parity_ok=parity)

    def _read_value(self, chips, value_page: int,
                    slot: int) -> tuple[bytes, bool]:
        """Gather the selected slot's chunk from the value page, inner-code
        checked.  A parity failure escalates to the full-page fallback when
        verification is on; otherwise the corrupted bytes are served (the
        measured wrong-result case the sweep quantifies)."""
        chunk = slot // SLOTS_PER_CHUNK
        chip, local = chips.route(value_page)
        sp = chip.pages[local]
        chip.counters.chunks_gathered += 1
        plain = chip._derandomized_chunk(sp, local, chunk)
        ok = bool(ecc.crc32_rows(plain[None, :])[0] == sp.chunk_parities[chunk])
        if not ok:
            if self.policy.verify_hits:
                self.stats.verify_failures += 1
                self._resolve_fallback(chips, value_page)  # repair or raise
                sp = chip.pages[local]
                plain = chip._derandomized_chunk(sp, local, chunk)
                ok = True
            else:
                self.stats.wrong_value_parity += 1
        off = (slot % SLOTS_PER_CHUNK) * 8
        return bytes(plain[off:off + 8]), ok

    def finalize_gather(self, chips, cmd: Command, resp: GatherResponse,
                        opens: dict[int, PageOpen]) -> GatherResponse:
        po = opens[cmd.page_addr]
        if po.verdict is OpenVerdict.UNCORRECTABLE:
            raise UncorrectableReadError(cmd.page_addr)
        if (self.policy.verify_hits and resp.chunk_ids.size
                and not np.asarray(resp.parity_ok).all()):
            bad = int((~np.asarray(resp.parity_ok)).sum())
            self.stats.verify_failures += bad
            self._resolve_fallback(chips, cmd.page_addr)  # repair or raise
            chip, local = chips.route(cmd.page_addr)
            sp = chip.pages[local]
            chunks = np.stack([chip._derandomized_chunk(sp, local, int(c))
                               for c in resp.chunk_ids])
            return GatherResponse(chunks=chunks, chunk_ids=resp.chunk_ids,
                                  parity_ok=np.ones(len(resp.chunk_ids),
                                                    dtype=bool))
        return resp
