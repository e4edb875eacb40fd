"""Device-resident page-plane store for the batched kernel backend.

The SiM chip's entire advantage is that stored pages never cross the bus —
only queries and 64 B bitmaps move (paper §III-B).  The card's analogue:
keep every staged page's word planes *resident in device memory* so a
steady-state flush ships only the (Q, 2) query operands, not 4 KiB per page
per flush.

The store is an arena of persistent tensors on one device:

    _lo, _hi    : (cap, 512) int32    — the de-interleaved word planes
    _ids        : (cap,)     int32    — chip-local flash address per row
    _seeds      : (cap,)     int32    — device seed per row

(int32 tensors hold uint32 bit patterns; the kernels read them unsigned.)

Rows are assigned lazily the first time a flush references a page and are
re-staged *incrementally*: the store subscribes to the write path of its
``SimChipArray`` (``add_observer``), so a ``program_entries`` — or a
bit-error injection or ECC repair, anything that mutates the stored image —
marks only that page's row dirty.  The next flush that touches the page
ships exactly one 4 KiB row host->device; untouched pages ship zero bytes.
The arena capacity grows by power-of-two blocks and existing rows are
carried over with a device-side copy, so growth never re-ships resident
pages.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.bits import PAGE_BYTES, SLOTS_PER_PAGE
from repro_torch.core.engine import SimChipArray
from repro_torch.device import resolve_device
from repro_torch.kernels.layout import pages_to_planes, words_to_tensor


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def padded_rows(n: int, block: int) -> int:
    """Pad a row count to a power-of-two multiple of ``block``.

    Kept from the JAX package, where it let bursts of similar size reuse
    one compiled kernel; here it fixes the launch geometry, so raw launch
    outputs compare equal between the two packages.
    """
    return block * next_pow2(-(-n // block))


class PlaneStore:
    """Arena of device-resident page planes, invalidated by the write path."""

    def __init__(self, chips: SimChipArray, *, block: int = 32, device=None,
                 log_staging: bool = False):
        self.chips = chips
        self.block = block
        self.device = resolve_device(device)
        self.log_staging = log_staging
        self._row: dict[int, int] = {}      # global page addr -> arena row
        self._addrs: list[int] = []         # arena row -> global page addr
        self._dirty: set[int] = set()
        self._cap = 0
        self._lo = self._hi = None          # (cap, 512) int32
        self._ids = self._seeds = None      # (cap,) int32
        self.staged_rows = 0                # rows shipped host->device, ever
        self.staged_bytes = 0               # page-plane bytes shipped, ever
        # Dirty restages since the log was last drained (``log_staging``).
        self.staged_log: list[int] = []
        # Subscribe through a weakref so an abandoned store (and its device
        # arena) stays collectable — the chip array outlives backends.
        ref = weakref.ref(self)
        chips.add_observer(lambda addr, _r=ref: (
            _r()._on_write(addr) if _r() is not None else None))

    # ------------------------------------------------------------ bookkeeping
    @property
    def resident_rows(self) -> int:
        return len(self._addrs)

    def _on_write(self, page_addr: int) -> None:
        if page_addr in self._row:
            self._dirty.add(page_addr)

    def _grow(self, need: int) -> None:
        cap = max(self._cap, self.block)
        while cap < need:
            cap *= 2
        if cap == self._cap:
            return
        new = [torch.zeros((cap, SLOTS_PER_PAGE), dtype=torch.int32,
                           device=self.device) for _ in range(2)] + [
               torch.zeros((cap,), dtype=torch.int32, device=self.device)
               for _ in range(2)]
        if self._lo is not None:
            # Device-side copy: growth never re-ships resident pages.
            for dst, src in zip(new, (self._lo, self._hi, self._ids,
                                      self._seeds)):
                dst[:self._cap].copy_(src)
        self._lo, self._hi, self._ids, self._seeds = new
        self._cap = cap

    # ---------------------------------------------------------------- staging
    def rows_for(self, page_addrs) -> np.ndarray:
        """Arena rows for global page addresses, staging new + dirty pages.

        Raises KeyError (via the chip model) on unprogrammed pages.  Returns
        (len(page_addrs),) int32.
        """
        rows = np.empty(len(page_addrs), np.int32)
        stage: list[int] = []
        dirty_staged: list[int] = []
        queued = set()
        for i, a in enumerate(page_addrs):
            a = int(a)
            r = self._row.get(a)
            if r is None:
                chip, local = self.chips.route(a)
                chip._get(local)            # KeyError on unprogrammed
                r = len(self._addrs)
                self._row[a] = r
                self._addrs.append(a)
                if a not in queued:
                    stage.append(a)
                    queued.add(a)
            elif a in self._dirty and a not in queued:
                stage.append(a)
                dirty_staged.append(a)
                queued.add(a)
            rows[i] = r
        if len(self._addrs) > self._cap:
            self._grow(len(self._addrs))
        if stage:
            self._stage(stage)
            if self.log_staging:
                self.staged_log.extend(dirty_staged)
        return rows

    def stage_group(self, page_addrs) -> int:
        """Re-stage a group of just-programmed pages in ONE device update.

        The deferred write path (``MatchBackend.submit_program``) calls this
        right after its grouped chip programs: every listed page that is
        resident-and-dirty, or not yet resident, ships in a single
        ``_stage`` scatter.  ``rows_for`` does all the work; this entry
        point only discards the row indices.  Returns the rows staged.
        """
        before = self.staged_rows
        self.rows_for([int(a) for a in page_addrs])
        return self.staged_rows - before

    def _stage(self, addrs: list[int]) -> None:
        """Ship the listed pages' planes host->device (the only page bytes
        that ever cross after warm-up: new rows and dirty rows).

        The arena is updated in place with ``index_copy_``, where the JAX
        arrays were immutable and each update made a new array.  In-place
        is safe for work already queued — ``take``'s copies and the
        kernels that read arena rows in place — because they and this
        update run in stream order on one CUDA stream (PyTorch's current
        stream of the arena's device): a launch queued before the update
        reads the planes of its flush.
        """
        s = spans.ON and spans.begin("planestore.restage")
        idx = words_to_tensor([self._row[a] for a in addrs], self.device,
                              np.int64)
        raws, ids, seeds = [], [], []
        for a in addrs:
            chip, local = self.chips.route(a)
            raws.append(chip.pages[local].raw)
            ids.append(local)
            seeds.append(chip.device_seed & 0xFFFFFFFF)
        lo, hi = pages_to_planes(np.stack(raws))
        self._lo.index_copy_(0, idx, words_to_tensor(lo, self.device))
        self._hi.index_copy_(0, idx, words_to_tensor(hi, self.device))
        self._ids.index_copy_(0, idx, words_to_tensor(
            np.asarray(ids, np.uint32), self.device))
        self._seeds.index_copy_(0, idx, words_to_tensor(
            np.asarray(seeds, np.uint32), self.device))
        self._dirty.difference_update(addrs)
        self.staged_rows += len(addrs)
        self.staged_bytes += len(addrs) * PAGE_BYTES
        if s:
            spans.end(s)

    # ----------------------------------------------------------------- access
    def arena(self):
        """The arena tensors (lo (cap, 512), hi (cap, 512), ids (cap,),
        seeds (cap,)) for kernels that read rows in place.  ``rows_for``
        may grow the arena, which replaces them: fetch them after it."""
        return self._lo, self._hi, self._ids, self._seeds

    def upload_rows(self, *row_sets, pad_to: int):
        """Arena row indices for kernels that read rows in place.

        Each set is checked against the resident rows while it is still
        numpy (the kernels trust their indices), padded to ``pad_to`` rows
        with row 0 as ``take`` pads, and all sets cross host->device in ONE
        copy.  Returns one (pad_to,) int32 device tensor per set.
        """
        stride = -(-pad_to // 4) * 4        # each set starts 16-byte aligned
        r = np.zeros((len(row_sets), stride), np.int32)
        for i, rows in enumerate(row_sets):
            rows = np.asarray(rows, np.int64)
            if len(rows) > pad_to:          # would be cut, not refused
                raise ValueError(f"{len(rows)} rows do not fit in {pad_to}")
            self._check_resident(rows)
            r[i, :len(rows)] = rows
        idx = words_to_tensor(r, self.device, np.int32)
        return tuple(idx[i, :pad_to] for i in range(len(row_sets)))

    def upload_rows2d(self, rows: np.ndarray) -> torch.Tensor:
        """A (C, R) matrix of arena rows for the chip-axis kernels, which
        read the rows in place: checked against the resident rows while it
        is still numpy, as ``upload_rows`` checks, and sent host->device in
        ONE copy.  The caller pads with row 0.  Returns (C, R) int32."""
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"rows must be (C, R), got shape {rows.shape}")
        self._check_resident(rows)
        return words_to_tensor(rows, self.device, np.int32)

    def _check_resident(self, rows: np.ndarray) -> None:
        """Refuse rows the arena does not hold: the kernels trust them."""
        if rows.size and (rows.min() < 0 or rows.max() >= self.resident_rows):
            raise IndexError(f"arena rows {rows.min()}..{rows.max()} "
                             f"outside the {self.resident_rows} resident")

    def take(self, rows: np.ndarray, pad_to: int):
        """Device-side row gather, padded to ``pad_to`` rows (repeats row 0).

        Returns (lo (P, 512), hi (P, 512), ids (P,), seeds (P,)) as fresh
        contiguous device tensors — no page bytes cross the bus here, only
        the row indices.  The plan flush uses it; the search, lookup and
        gather kernels read the arena in place (``arena``, ``upload_rows``)
        and copy nothing.
        """
        r = np.zeros(pad_to, np.int64)
        r[:len(rows)] = rows
        ridx = words_to_tensor(r, self.device, np.int64)
        return self._select(ridx)

    def take2d(self, rows: np.ndarray):
        """Row gather for a (C, R) index matrix, one device op per arena
        tensor: the chip-axis plan flush's operands.  Returns (lo (C, R,
        512), hi (C, R, 512), ids (C, R), seeds (C, R))."""
        rows = np.asarray(rows, np.int64)
        ridx = words_to_tensor(rows.ravel(), self.device, np.int64)
        lo, hi, ids, seeds = self._select(ridx)
        c, r = rows.shape
        return (lo.reshape(c, r, SLOTS_PER_PAGE), hi.reshape(c, r,
                                                            SLOTS_PER_PAGE),
                ids.reshape(c, r), seeds.reshape(c, r))

    def _select(self, ridx: torch.Tensor):
        return (self._lo.index_select(0, ridx), self._hi.index_select(0, ridx),
                self._ids.index_select(0, ridx),
                self._seeds.index_select(0, ridx))
