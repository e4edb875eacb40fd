"""Functional model of one SiM chip (paper §III, §IV-B).

Semantics only — time and energy live in flash/ssd.py.  The model is
bit-exact about everything the paper's circuit does:

  * pages are stored *randomized* (per-chunk streams, §IV-C1);
  * `page_open` senses the array into Latch 1 and ships header+chunk0 to the
    controller for the Optimistic-Error-Correction check (§IV-C2);
  * `page_close` rotates L1 -> L2, freeing the array for the next sense
    (the latch pipeline that lets sensing overlap matching);
  * `search` broadcasts a randomized query into Latch 4, XORs against L2 into
    Latch 3, and the FBC per-64-bitline group reduction yields the 512-bit
    match bitmap (here: an exact OR-reduce);
  * `gather` selects chunks through the column decoder and de-randomizes +
    inner-code-verifies them on the controller side.

Bit errors are injected into the *stored* (randomized) image so every
integrity mechanism is exercised for real: header CRC catches chunk-0 damage,
inner CRCs catch chunk damage, and matching on a damaged page can genuinely
return wrong bitmaps when the optimistic check misses body-only errors —
exactly the risk the paper's sampling argument accepts (§IV-C2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import spans

from . import ecc
from .bits import CHUNK_BYTES, CHUNKS_PER_PAGE, PAGE_BYTES, unpack_bitmap
from .commands import (Command, GatherResponse, Op, ReadFullResponse,
                       SearchResponse)
from .ecc import EccConfig, OpenVerdict, optimistic_open
from .page import BuiltPage, build_page, page_slot_words
from .randomize import chunk_stream_words, randomize_query, stream_words


@dataclasses.dataclass
class StoredPage:
    raw: np.ndarray                # randomized on-flash image, (4096,) uint8
    chunk_parities: np.ndarray     # (64,) uint32 (out-of-band)
    timestamp_ns: int
    injected_error_bits: int = 0
    n_entries: int = 0
    # Simulator-only ground truth: the error-free image.  A t-error-
    # correcting outer code deterministically recovers it when the raw
    # bit-error count is <= t; storing it is how ECC simulators realize that
    # recovery without implementing BCH decoding.
    clean_raw: np.ndarray | None = None


@dataclasses.dataclass
class ChipCounters:
    array_reads: int = 0           # NAND sense operations
    searches: int = 0
    gathers: int = 0
    chunks_gathered: int = 0
    programs: int = 0
    full_reads: int = 0
    open_fallbacks: int = 0
    open_refreshes: int = 0
    pipelined_opens: int = 0       # opens whose sense overlapped matching


class SimChip:
    """One flash chip with match-mode (SLC) pages."""

    def __init__(self, n_pages: int, device_seed: int = 0,
                 ecc_cfg: EccConfig | None = None):
        self.n_pages = n_pages
        self.device_seed = device_seed
        self.ecc_cfg = ecc_cfg or EccConfig()
        self.pages: dict[int, StoredPage] = {}
        self.counters = ChipCounters()
        # Write-path observers: called with the local page address whenever a
        # stored image mutates (program, bit-error injection, ECC repair).
        # Backends that mirror pages off-host (the device-resident plane
        # store) subscribe here to invalidate exactly the dirty row.
        self.observers: list = []
        # Latch pipeline state: addresses currently held in L1 / L2.
        self._l1_addr: int | None = None
        self._l2_addr: int | None = None
        self._rng = np.random.default_rng(device_seed ^ 0xD1CE)

    def _notify(self, page_addr: int) -> None:
        for fn in self.observers:
            fn(page_addr)

    # ------------------------------------------------------------------ I/O
    def program_entries(self, page_addr: int, entries: np.ndarray, *,
                        timestamp_ns: int = 0,
                        header_user: np.ndarray | None = None) -> BuiltPage:
        if not (0 <= page_addr < self.n_pages):
            raise IndexError(page_addr)
        s = spans.ON and spans.begin("chip.program")
        built = build_page(entries, page_addr, timestamp_ns=timestamp_ns,
                           header_user=header_user,
                           device_seed=self.device_seed)
        self.pages[page_addr] = StoredPage(
            raw=built.raw.copy(), chunk_parities=built.chunk_parities,
            timestamp_ns=timestamp_ns, n_entries=built.n_entries,
            clean_raw=built.raw.copy())
        self.counters.programs += 1
        self._notify(page_addr)
        if s:
            spans.end(s)
        return built

    def inject_bit_errors(self, page_addr: int, n_bits: int,
                          rng: np.random.Generator | None = None,
                          byte_region: tuple[int, int] | None = None) -> None:
        """Flip n random bits in the stored image (retention/read-disturb).

        ``byte_region=(start, stop)`` confines the flips — tests use
        (0, 64) to hit the verification-header chunk deterministically and
        (64, 4096) to model the body-only damage the optimistic check is
        blind to (the acknowledged risk of §IV-C2).
        """
        rng = rng or self._rng
        sp = self.pages[page_addr]
        lo, hi = byte_region or (0, PAGE_BYTES)
        bit_idx = lo * 8 + rng.choice((hi - lo) * 8, size=n_bits,
                                      replace=False)
        bytes_idx, bit_in_byte = bit_idx // 8, bit_idx % 8
        np.bitwise_xor.at(sp.raw, bytes_idx,
                          (1 << bit_in_byte).astype(np.uint8))
        sp.injected_error_bits += int(n_bits)
        self._notify(page_addr)

    # ------------------------------------------------------------ commands
    def page_open(self, page_addr: int, *, now_ns: int = 0):
        """Sense into L1 and run the optimistic header check.

        Returns (OpenResult, pipelined: bool).  ``pipelined`` is True when L2
        still held the previous page, i.e. this sense overlapped matching.
        """
        sp = self._get(page_addr)
        pipelined = self._l2_addr is not None and self._l1_addr is None
        self.counters.array_reads += 1
        if pipelined:
            self.counters.pipelined_opens += 1
        self._l1_addr = page_addr

        header_plain = self._derandomized_chunk(sp, page_addr, 0)
        result = optimistic_open(
            header_plain, now_ns=now_ns,
            injected_error_bits=sp.injected_error_bits,
            cfg=self.ecc_cfg, rng=self._rng)
        if result.verdict in (OpenVerdict.FALLBACK_ECC,
                              OpenVerdict.UNCORRECTABLE):
            self.counters.open_fallbacks += 1
            if result.verdict is OpenVerdict.FALLBACK_ECC:
                # Outer decode repaired the stored image.
                self._repair(sp, page_addr)
        elif result.verdict is OpenVerdict.CLEAN_NEEDS_REFRESH:
            self.counters.open_refreshes += 1
        return result, pipelined

    def page_close(self, page_addr: int) -> None:
        if self._l1_addr != page_addr:
            raise RuntimeError(f"page {page_addr} is not in L1")
        self._l2_addr, self._l1_addr = page_addr, None

    def latch(self, page_addr: int) -> int:
        """Latch a page in L2 for a search: the implicit open/close of the
        convenience paths (engine-level only; the SSD scheduler always
        issues opens explicitly), skipped when the page is latched already.
        Returns the open verdict's value, CLEAN when no open ran."""
        if self._l2_addr == page_addr:
            return OpenVerdict.CLEAN.value
        result, _ = self.page_open(page_addr)
        self.page_close(page_addr)
        return result.verdict.value

    def search(self, cmd: Command) -> SearchResponse:
        """Execute a search against the page currently latched in L2."""
        if cmd.op is not Op.SEARCH:
            raise ValueError(cmd.op)
        verdict = self.latch(cmd.page_addr)
        sp = self.pages[cmd.page_addr]
        words = page_slot_words(sp.raw)
        # Deserializer randomizes the query with the page's stream (§IV-C1):
        q = randomize_query(np.array(cmd.query, dtype=np.uint32),
                            cmd.page_addr, self.device_seed)
        mask = np.array(cmd.mask, dtype=np.uint32)
        mismatch = ((words[:, 0] ^ q[:, 0]) & mask[0]) | (
            (words[:, 1] ^ q[:, 1]) & mask[1])
        bits = (mismatch == 0).astype(np.uint32)
        from .bits import pack_bitmap
        bitmap = pack_bitmap(bits)
        self.counters.searches += 1
        return SearchResponse(bitmap_words=bitmap,
                              match_count=int(bits.sum()),
                              open_verdict=verdict)

    def gather(self, cmd: Command) -> GatherResponse:
        if cmd.op is not Op.GATHER:
            raise ValueError(cmd.op)
        sp = self._get(cmd.page_addr)
        if self._l2_addr != cmd.page_addr and self._l1_addr != cmd.page_addr:
            self.counters.array_reads += 1      # cold gather needs a sense
            self._l1_addr = cmd.page_addr
        bm = np.array(cmd.chunk_bitmap, dtype=np.uint32)
        bits = unpack_bitmap(bm, n_bits=CHUNKS_PER_PAGE)
        chunk_ids = np.nonzero(bits)[0]
        plain = np.stack([
            self._derandomized_chunk(sp, cmd.page_addr, int(c))
            for c in chunk_ids]) if chunk_ids.size else np.zeros(
                (0, CHUNK_BYTES), dtype=np.uint8)
        parity_ok = (ecc.crc32_chunks(self._derandomize_page(sp, cmd.page_addr))
                     [chunk_ids] == sp.chunk_parities[chunk_ids]
                     ) if chunk_ids.size else np.zeros(0, dtype=bool)
        self.counters.gathers += 1
        self.counters.chunks_gathered += int(chunk_ids.size)
        return GatherResponse(chunks=plain, chunk_ids=chunk_ids,
                              parity_ok=parity_ok)

    def read_full(self, page_addr: int) -> ReadFullResponse:
        sp = self._get(page_addr)
        self.counters.array_reads += 1
        self.counters.full_reads += 1
        return ReadFullResponse(plain=self._derandomize_page(sp, page_addr))

    # ------------------------------------------------------------- helpers
    def _get(self, page_addr: int) -> StoredPage:
        if page_addr not in self.pages:
            raise KeyError(f"page {page_addr} unprogrammed")
        return self.pages[page_addr]

    def _derandomize_page(self, sp: StoredPage, page_addr: int) -> np.ndarray:
        from .bits import bytes_to_slot_words, slot_words_to_bytes
        words = bytes_to_slot_words(sp.raw)
        plain = words ^ stream_words(page_addr, self.device_seed)
        return slot_words_to_bytes(plain)

    def _derandomized_chunk(self, sp: StoredPage, page_addr: int,
                            chunk_idx: int) -> np.ndarray:
        from .bits import bytes_to_slot_words, slot_words_to_bytes
        start = chunk_idx * CHUNK_BYTES
        chunk = sp.raw[start:start + CHUNK_BYTES]
        words = bytes_to_slot_words(chunk)
        plain = words ^ chunk_stream_words(page_addr, chunk_idx,
                                           self.device_seed)
        return slot_words_to_bytes(plain)

    def _repair(self, sp: StoredPage, page_addr: int) -> None:
        """Outer-code decode success (error count <= t): restore the clean
        image from the simulator's ground truth and verify the inner codes
        agree — a real BCH/LDPC decode is deterministic under the t-bound."""
        assert sp.clean_raw is not None
        sp.raw = sp.clean_raw.copy()
        sp.injected_error_bits = 0
        self._notify(page_addr)
        plain = self._derandomize_page(sp, page_addr)
        ok = ecc.crc32_chunks(plain) == sp.chunk_parities
        assert ok.all(), "repaired image fails inner parities — layout bug"


class SimChipArray:
    """A convenience wrapper over several chips (one per channel/die) that
    routes page addresses by simple striping.  The SSD simulator uses its own
    geometry; this class serves the functional/index layers."""

    def __init__(self, n_chips: int, pages_per_chip: int,
                 device_seed: int = 0):
        self.chips = [SimChip(pages_per_chip, device_seed=device_seed + i)
                      for i in range(n_chips)]
        self.pages_per_chip = pages_per_chip
        # Array-level write observers, called with the *global* page address.
        # Each chip's local notifications are translated back through the
        # striping so subscribers (e.g. the device-resident plane store) see
        # the same address space callers use.
        self.observers: list = []
        for idx, chip in enumerate(self.chips):
            chip.observers.append(
                lambda local, _i=idx: self._notify_global(
                    local * len(self.chips) + _i))

    def _notify_global(self, page_addr: int) -> None:
        for fn in self.observers:
            fn(page_addr)

    def add_observer(self, fn) -> None:
        """Subscribe to stored-image mutations (fn(global_page_addr))."""
        self.observers.append(fn)

    def route(self, page_addr: int) -> tuple["SimChip", int]:
        return (self.chips[page_addr % len(self.chips)],
                page_addr // len(self.chips))

    def program_entries(self, page_addr: int, entries, **kw):
        chip, local = self.route(page_addr)
        return chip.program_entries(local, entries, **kw)

    def latch(self, page_addr: int) -> int:
        chip, local = self.route(page_addr)
        return chip.latch(local)

    def search(self, cmd: Command) -> SearchResponse:
        chip, local = self.route(cmd.page_addr)
        return chip.search(dataclasses.replace(cmd, page_addr=local))

    def gather(self, cmd: Command) -> GatherResponse:
        chip, local = self.route(cmd.page_addr)
        return chip.gather(dataclasses.replace(cmd, page_addr=local))

    def read_full(self, page_addr: int) -> ReadFullResponse:
        chip, local = self.route(page_addr)
        return chip.read_full(local)
