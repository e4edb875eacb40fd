"""SiM-paged KV cache: the paper's technique as a first-class serving
feature.

A vLLM-style paged KV cache needs a *block table*: (sequence, logical
block) -> physical page.  That table is exactly the kind of index the paper
accelerates — fixed-width keys, masked point lookups, high fan-out — so
here it lives on SiM flash pages and is queried with real ``search``
commands through the functional chip engine (host side, numpy):

    key slot (8 B, BitWeaving):  [seq_id:24 | logical_block:20 | phys:20]

A lookup masks out the ``phys`` field and matches on (seq_id, block); the
matching slot's own bits carry the physical page id (one search command,
no gather).  Freeing a sequence reuses the §V-D keyspace-partition trick:
one masked search per sequence isolates all its table entries.

The KV payload pool is a pair of device tensors, written in place; only
the *index* rides SiM — the paper's data/metadata separation (Fig 4).  The
pool holds the k/v that grows with a sequence: every layer's, or for a
``HymbaConfig`` each global-layer cache's (its window rings and mamba
state are fixed in size and stay with the sequence's dense caches).

A sequence's table entries for blocks ``[k * TABLE_SPAN, (k + 1) *
TABLE_SPAN)`` live on table page ``(seq_id + k) % table_pages``, so that a
long sequence spreads over pages and a short one keeps to one; freeing a
sequence runs one partition search on each page that holds its entries.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bits import unpack_bitmap
from repro_torch.core.bitweaving import Column, RowCodec
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.page import USER_SLOTS, mask_header_slots
from repro_torch.device import resolve_device
from repro_torch.models import hymba
from repro_torch.models.config import HymbaConfig, ModelConfig
from repro_torch.models.layers import pdtype
from repro_torch.reliability import require_clean

TABLE_CODEC = RowCodec([Column("seq", 24), Column("block", 20),
                        Column("phys", 20)])
TABLE_SPAN = 128        # blocks of a sequence on one table page


def paged_layers(cfg: ModelConfig) -> int:
    """The k/v caches a token's page holds: a ``HymbaConfig``'s global
    caches, else every layer's."""
    return hymba.n_caches(cfg, "global") if isinstance(cfg, HymbaConfig) \
        else cfg.n_layers


@dataclasses.dataclass
class PagedStats:
    searches: int = 0
    programs: int = 0
    pages_allocated: int = 0
    pages_freed: int = 0


class SimPagedKVCache:
    """Physical KV page pool on ``device`` + SiM-resident block table
    (single layer-stack pool of :func:`paged_layers` caches; they index the
    same physical pages)."""

    def __init__(self, cfg: ModelConfig, *, n_pages: int,
                 page_tokens: int = 16, table_pages: int = 8,
                 n_chips: int = 4, device=None):
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.n_pages = n_pages
        device = resolve_device(device)
        shape = (paged_layers(cfg), n_pages, page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        self.pool_k = torch.zeros(shape, dtype=pdtype(cfg), device=device)
        self.pool_v = torch.zeros(shape, dtype=pdtype(cfg), device=device)
        self.chips = SimChipArray(n_chips=n_chips,
                                  pages_per_chip=table_pages)
        self.table_pages = table_pages
        self._entries: dict[int, list[int]] = {p: []
                                               for p in range(table_pages)}
        self._free = list(range(n_pages - 1, -1, -1))
        self._pages_of: dict[int, set[int]] = {}
        self.stats = PagedStats()
        for p in range(table_pages):
            self.chips.program_entries(p, np.zeros(0, dtype=np.uint64))

    @property
    def free_pages(self) -> int:
        """Pages of the pool on the free list."""
        return len(self._free)

    # ------------------------------------------------------------ table io
    def _table_page_of(self, seq_id: int, logical_block: int) -> int:
        return (seq_id + logical_block // TABLE_SPAN) % self.table_pages

    def _reprogram(self, page: int) -> None:
        self.chips.program_entries(
            page, np.array(self._entries[page], dtype=np.uint64))
        self.stats.programs += 1

    def _search(self, page: int, query: int, mask: int) -> np.ndarray:
        """One search command on table page ``page``: the matching user
        slots that hold an entry."""
        resp = require_clean(self.chips.search(Command.search(page, query,
                                                              mask)))
        self.stats.searches += 1
        bitmap = mask_header_slots(resp.bitmap_words)
        slots = np.nonzero(unpack_bitmap(bitmap, 512))[0]
        return slots[slots - 8 < len(self._entries[page])]

    def allocate(self, seq_id: int, logical_block: int) -> int:
        if not self._free:
            raise RuntimeError("KV pool exhausted")
        page = self._table_page_of(seq_id, logical_block)
        if len(self._entries[page]) >= USER_SLOTS:
            raise RuntimeError("block-table page full")
        phys = self._free.pop()
        key = TABLE_CODEC.encode(seq=seq_id, block=logical_block, phys=phys)
        self._entries[page].append(key)
        self._pages_of.setdefault(seq_id, set()).add(page)
        self._reprogram(page)
        self.stats.pages_allocated += 1
        return phys

    def lookup(self, seq_id: int, logical_block: int) -> int | None:
        """One masked search command -> physical page id."""
        mq_seq = TABLE_CODEC.equals("seq", seq_id)
        mq_blk = TABLE_CODEC.equals("block", logical_block)
        page = self._table_page_of(seq_id, logical_block)
        slots = self._search(page, mq_seq.query | mq_blk.query,
                             mq_seq.mask | mq_blk.mask)   # phys: don't care
        if slots.size == 0:
            return None
        return TABLE_CODEC.decode(self._entries[page][int(slots[0]) - 8],
                                  "phys")

    def free_sequence(self, seq_id: int) -> int:
        """§V-D partition-style eviction: one masked search on each table
        page that holds the sequence's entries isolates them all, freed in
        one sweep."""
        pages = self._pages_of.pop(seq_id, {self._table_page_of(seq_id, 0)})
        return sum(self._free_on(page, seq_id) for page in sorted(pages))

    def _free_on(self, page: int, seq_id: int) -> int:
        mq = TABLE_CODEC.equals("seq", seq_id)
        slots = self._search(page, mq.query, mq.mask)
        keep = []
        for key in self._entries[page]:
            if TABLE_CODEC.decode(key, "seq") == seq_id:
                self._free.append(TABLE_CODEC.decode(key, "phys"))
            else:
                keep.append(key)
        freed = len(self._entries[page]) - len(keep)
        if freed != slots.size:
            raise RuntimeError(f"sequence {seq_id}: the search found "
                               f"{slots.size} table entries, the host {freed}")
        self._entries[page] = keep
        self._reprogram(page)
        self.stats.pages_freed += freed
        return freed

    # ----------------------------------------------------------- kv access
    def write_token(self, seq_id: int, position: int, k, v) -> None:
        """k, v: (paged layers, Hkv, hd) for one token, written into the
        pool in place."""
        self.write_tokens(seq_id, position, k[:, None], v[:, None])

    def write_tokens(self, seq_id: int, start: int, k, v) -> None:
        """k, v: (paged layers, S, Hkv, hd) for positions start..start+S-1,
        written into the pool in place: one lookup command (and for a new
        page one allocation) a page they touch."""
        pos, end = start, start + k.shape[1]
        while pos < end:
            block, off = divmod(pos, self.page_tokens)
            n = min(self.page_tokens - off, end - pos)
            phys = self.lookup(seq_id, block)
            if phys is None:
                phys = self.allocate(seq_id, block)
            rows = slice(pos - start, pos - start + n)
            self.pool_k[:, phys, off:off + n] = k[:, rows]
            self.pool_v[:, phys, off:off + n] = v[:, rows]
            pos += n

    def gather_sequence(self, seq_id: int, length: int):
        """Contiguous (L, length, Hkv, hd) copies for attention."""
        n_blocks = -(-length // self.page_tokens)
        phys = [self.lookup(seq_id, b) for b in range(n_blocks)]
        if any(p is None for p in phys):
            raise KeyError(f"sequence {seq_id}: a KV page of its first "
                           f"{length} tokens is missing")
        k = torch.cat([self.pool_k[:, p] for p in phys], dim=1)
        v = torch.cat([self.pool_v[:, p] for p in phys], dim=1)
        return k[:, :length], v[:, :length]
