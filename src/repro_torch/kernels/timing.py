"""Device timing of the SiM kernels on the card: warm, and against a cold
arena the size of the replay's.

``device_ms`` times a call by CUDA events.  ``cold_ms`` times a kernel that
reads rows of an arena as large as the replay's ``PlaneStore`` (32,768 rows
of lo/hi planes, 128 MiB, over the H100's 50 MB L2) with a fresh random set
of rows on every launch, the way a replay's bursts find the pages.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels.sim_search.ref import stream_planes, to_i32, u32

# The replay's PlaneStore at full size: 16,384 key and 16,384 value pages.
ARENA_ROWS = 32_768
L2_BYTES = 50 << 20
ITERS = 200


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``, from CUDA events around ``iters``
    back-to-back calls.  A spin kernel holds the stream while the host
    queues the calls, so host launch overhead does not enter the time.
    ``fn`` runs ``iters + 2`` times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s * iters + 0.005) * 2.0e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flush_l2(device) -> None:
    """Evict the L2: write a buffer of twice its size."""
    torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=device).fill_(1)
    torch.cuda.synchronize(device)


def cold_ms(launch, iters: int, device) -> float:
    """Device time per ``launch(i)``, call i using index set i, none twice
    (``iters + 2`` sets), after the L2 is flushed."""
    calls = iter(range(iters + 2))
    flush_l2(device)
    return device_ms(lambda: launch(next(calls)), iters)


def random_arena(device, rows: int = ARENA_ROWS, seed: int = 0):
    """(lo (rows, 512), hi (rows, 512), ids (rows,), seeds (rows,)) int32
    arena of random words, made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (torch.randint(-2**31, 2**31, (rows, 512), generator=g,
                            dtype=torch.int32, device=device)
              for _ in range(2))
    ids = torch.randint(0, 2**20, (rows,), generator=g, dtype=torch.int32,
                        device=device)
    seeds = torch.randint(-2**31, 2**31, (rows,), generator=g,
                          dtype=torch.int32, device=device)
    return lo, hi, ids, seeds


def row_sets(n_sets: int, n: int, cap: int, seed: int, device,
             exclude=None) -> torch.Tensor:
    """(n_sets, n) int32: each row a random set of n distinct arena rows
    (none from ``exclude``, a (n_sets, n) array of rows to avoid)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_sets, n), np.int32)
    for i in range(n_sets):
        pick = rng.choice(cap, size=n + (0 if exclude is None else n),
                          replace=False)
        if exclude is not None:
            pick = pick[~np.isin(pick, exclude[i])]
        out[i] = pick[:n]
    return torch.from_numpy(out).to(device)


def planted_lookup_queries(lo, hi, ids, seeds, key_sets, seed: int):
    """(n_sets, n, 2) int32 queries that hit a user slot of their key row,
    every fourth a random query that misses, with all-ones masks: query i
    of set j matches one slot in 8..511 of arena row ``key_sets[j, i]`` in
    the randomized domain."""
    n_sets, n = key_sets.shape
    g = torch.Generator(device=lo.device).manual_seed(seed)
    rows = key_sets.reshape(-1).to(torch.int64)
    slot = torch.randint(8, 512, (rows.numel(),), generator=g,
                         device=lo.device)
    at = (torch.arange(rows.numel(), device=lo.device), slot)
    s_lo, s_hi = stream_planes(ids[rows], seeds[rows])
    q = torch.stack([u32(lo[rows, slot]) ^ s_lo[at],
                     u32(hi[rows, slot]) ^ s_hi[at]], dim=1)
    q = to_i32(q).reshape(n_sets, n, 2)
    q[:, 3::4] = torch.randint(-2**31, 2**31, q[:, 3::4].shape, generator=g,
                               dtype=torch.int32, device=lo.device)
    return q.contiguous()
