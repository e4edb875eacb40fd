"""Carry stored chip state across packages as plain numpy and ints.

This system has no weights; its stored pages play that role.  The state of
a ``SimChipArray`` is, per chip, its ``device_seed`` and ``pages_per_chip``
and, per programmed page, the ``StoredPage`` fields (``raw``,
``clean_raw``, ``chunk_parities``, ``timestamp_ns``, ``n_entries``,
``injected_error_bits``).  :func:`chip_array_to_numpy` reads that state off
any object with the ``SimChipArray`` attribute layout — the JAX package's
or this one's — and :func:`chip_array_from_numpy` builds the port's
``SimChipArray`` from it, bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import SimChipArray, StoredPage

PAGE_FIELDS = ("raw", "clean_raw", "chunk_parities", "timestamp_ns",
               "n_entries", "injected_error_bits")


def chip_array_to_numpy(chips) -> dict:
    """State of a chip array as ``{"chips": [{"device_seed",
    "pages_per_chip", "pages": {local_addr: {field: value}}}]}``, with
    every array copied to numpy and every scalar an int."""
    out = []
    for chip in chips.chips:
        pages = {}
        for local, sp in chip.pages.items():
            page = {}
            for f in PAGE_FIELDS:
                v = getattr(sp, f)
                page[f] = (None if v is None else np.array(v, copy=True)
                           if isinstance(v, np.ndarray) else int(v))
            pages[int(local)] = page
        out.append({"device_seed": int(chip.device_seed),
                    "pages_per_chip": int(chips.pages_per_chip),
                    "pages": pages})
    return {"chips": out}


def chip_array_from_numpy(state: dict) -> SimChipArray:
    """Build the port's ``SimChipArray`` from :func:`chip_array_to_numpy`
    state.  Chip ``i`` must carry seed ``chips[0].device_seed + i`` and all
    chips the same ``pages_per_chip``, as a ``SimChipArray`` makes them."""
    chips = state["chips"]
    if not chips:
        raise ValueError("state holds no chips")
    base, per_chip = chips[0]["device_seed"], chips[0]["pages_per_chip"]
    for i, c in enumerate(chips):
        if c["device_seed"] != base + i or c["pages_per_chip"] != per_chip:
            raise ValueError(f"chip {i} (seed {c['device_seed']}, "
                             f"{c['pages_per_chip']} pages) does not fit a "
                             f"SimChipArray of base seed {base}")
    arr = SimChipArray(n_chips=len(chips), pages_per_chip=per_chip,
                       device_seed=base)
    for chip, c in zip(arr.chips, chips):
        for local, page in c["pages"].items():
            if not 0 <= int(local) < per_chip:
                raise IndexError(f"page {local} outside chip of {per_chip}")
            clean = page["clean_raw"]
            chip.pages[int(local)] = StoredPage(
                raw=np.array(page["raw"], dtype=np.uint8, copy=True),
                chunk_parities=np.array(page["chunk_parities"],
                                        dtype=np.uint32, copy=True),
                timestamp_ns=int(page["timestamp_ns"]),
                injected_error_bits=int(page["injected_error_bits"]),
                n_entries=int(page["n_entries"]),
                clean_raw=(None if clean is None else
                           np.array(clean, dtype=np.uint8, copy=True)))
    return arr
