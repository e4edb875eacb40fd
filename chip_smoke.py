"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py              # the full run, from the repo root

Phases, in order; any failure exits non-zero and no phase is skipped:

1. Device: the card's name and power limit, and the time to build the
   CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Kernel checks: each kernel against its plain PyTorch version on the
   card, bit-exact, on inputs with planted hits, with CUDA-event times
   per launch for both and the kernel's bound at the timed shapes.
3. Replays through ``repro_torch.frontend.replay`` on the ``batched``
   backend, each checked against a numpy oracle of serial semantics:
   YCSB-B split and fused (they must also agree), YCSB-E range scans
   (fused, one ``sim_plan`` launch a scan; the first scans are also held
   against the per-pass search path) and YCSB-A through the §VI DRAM write
   buffer (fused).  The launch counts, set to 0 before each path and read
   after it, show which kernels ran on that path.
4. One JSON line of the kernels, their launches and times.
5. The card's ``nvidia-smi`` name and power limit, then the last line:
   ``{"ok": true, "device": {...}}``.

The default scale is 20% of the paper's 650 MiB index: 16,384 key pages
and 16,384 value pages of 4 KiB on 16 chips, for every path.
``--key-pages`` and ``--n-ops`` cut it for a quick check.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.backend import BatchedKernelBackend  # noqa: E402
from repro_torch.core.commands import Command  # noqa: E402
from repro_torch.core.engine import SimChipArray  # noqa: E402
from repro_torch.core.page import mask_header_slots  # noqa: E402
from repro_torch.core.range_query import (RangePlan,  # noqa: E402
                                          approximate_range,
                                          evaluate_plan_on_pages,
                                          evaluate_plan_per_pass, exact_range)
from repro_torch.frontend import RunConfig, replay  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.layout import (tensor_to_words,  # noqa: E402
                                        words_to_tensor)
from repro_torch.kernels.sim_fused.ops import sim_fused_lookup  # noqa: E402
from repro_torch.kernels.sim_fused.ref import sim_lookup_ref  # noqa: E402
from repro_torch.kernels.sim_gather.ops import sim_gather  # noqa: E402
from repro_torch.kernels.sim_gather.ref import sim_gather_ref  # noqa: E402
from repro_torch.kernels.sim_plan.ops import sim_plan  # noqa: E402
from repro_torch.kernels.sim_plan.ref import (plan_pass_rows,  # noqa: E402
                                              sim_plan_ref)
from repro_torch.kernels.sim_search.ops import sim_search  # noqa: E402
from repro_torch.kernels.sim_search.ref import (sim_search_ref,  # noqa: E402
                                                stream_planes)
from repro_torch.workload.ycsb import KEYS_PER_PAGE, generate  # noqa: E402

# H100 SXM peaks at the 700 W power limit: HBM3 at 3.35 TB/s (NVIDIA data
# sheet), and 32-bit integer add, compare, logic and shift at 64 results
# per SM per clock for compute capability 9.0 (CUDA C++ Programming Guide,
# "Arithmetic Instructions" throughput table): 132 SMs x 64 x 1.98 GHz
# boost.  Integer multiplies are counted at the same rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations of the §IV-C1 stream for one slot: counter (3) + two
# mix2_32 of 17 each + XOR into the lo and hi words (2).
STREAM_OPS = 39
# Per (query, slot) match: 2 XOR, 2 AND, 1 OR, 1 compare.
MATCH_OPS = 6
# Per (real plan pass, slot): the match and an OR into its accumulator.
PASS_OPS = MATCH_OPS + 1

SRC = "src/repro_torch/kernels/csrc"
KERNELS = {
    "sim_search": (f"{SRC}/sim_search.cu",
                   "src/repro/kernels/sim_search/sim_search.py:47"),
    "sim_gather": (f"{SRC}/sim_gather.cu",
                   "src/repro/kernels/sim_gather/sim_gather.py:31"),
    "sim_lookup": (f"{SRC}/sim_lookup.cu",
                   "src/repro/kernels/sim_fused/sim_fused.py:175"),
    "sim_plan": (f"{SRC}/sim_plan.cu",
                 "src/repro/kernels/sim_plan/sim_plan.py:49"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``, from CUDA events around ``iters``
    back-to-back calls.  A spin kernel holds the stream while the host
    queues the calls, so host launch overhead does not enter the time."""
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


def max_abs_err(kernel_out, plain_out) -> int:
    err = 0
    for k, p in zip(kernel_out, plain_out):
        a = tensor_to_words(k).astype(np.int64)
        b = tensor_to_words(p).astype(np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} != plain {b.shape}")
        err = max(err, int(np.abs(a - b).max(initial=0)))
    return err


# --------------------------------------------------------------- phase 2
def stream_np(ids, seeds):
    """The §IV-C1 stream of each page, (N, 512) lo and hi uint32 planes,
    from the plain version's own generator on the CPU."""
    s_lo, s_hi = stream_planes(words_to_tensor(ids, "cpu"),
                               words_to_tensor(seeds, "cpu"))
    return s_lo.numpy().astype(np.uint32), s_hi.numpy().astype(np.uint32)


def search_case(dev, n_pages, n_queries, seed):
    """Random planes and queries with planted hits in the randomized
    domain: even queries match one (page, slot) under a full mask, odd
    ones a 4-bit mask of the lo word (about 1 slot in 16), the last is a
    pad query (q = 0, m = 0) that matches every slot.  Returns the
    operands and the planted ``(query, page, slot)`` cells."""
    rng = np.random.default_rng(seed)
    lo, hi = u32(rng, (n_pages, 512)), u32(rng, (n_pages, 512))
    q, m = u32(rng, (n_queries, 2)), u32(rng, (n_queries, 2))
    ids = rng.integers(0, 2048, n_pages).astype(np.uint32)
    seeds = (7 + rng.integers(0, 16, n_pages)).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    planted = []
    for i in range(n_queries):
        if i % 2 == 0:
            p, s = int(rng.integers(n_pages)), int(rng.integers(512))
            q[i] = [lo[p, s] ^ s_lo[p, s], hi[p, s] ^ s_hi[p, s]]
            m[i] = [0xFFFFFFFF, 0xFFFFFFFF]
            planted.append((i, p, s))
        else:
            m[i] = [0xF, 0]
    if n_queries > 2:
        q[-1], m[-1] = 0, 0
    return ([words_to_tensor(a, dev) for a in (lo, hi, q, m, ids, seeds)],
            planted)


def check_search_hits(plain, planted):
    """The planted cells are set in the plain output, and the masked and
    pad queries match many slots: the comparison is not of empty maps."""
    bm = tensor_to_words(plain)
    for i, p, s in planted:
        if not (int(bm[i, p, s // 32]) >> (s % 32)) & 1:
            raise AssertionError(f"planted search hit {(i, p, s)} missing")
    bits = np.unpackbits(bm.view(np.uint8), axis=-1).sum(axis=(1, 2))
    if bits.min() == 0 or (bm.shape[0] > 2 and bits[-1] != bm.shape[1] * 512):
        raise AssertionError(f"search check has too few hits: {bits}")


def gather_case(dev, n_pages, seed):
    rng = np.random.default_rng(seed)
    bm = u32(rng, (n_pages, 2))               # ~32 of 64 chunks: overflows 4
    bm[1] = 0                                 # an empty selection
    bm[2] = 0xFFFFFFFF                        # all 64 chunks
    return (words_to_tensor(u32(rng, (n_pages, 64, 16)), dev),
            words_to_tensor(bm, dev))


def lookup_case(dev, n_rows, seed):
    """Random key and value planes with planted hits in the randomized
    domain.  Row i (by i % 4): 0 — a user slot, a later user slot and a
    header slot all match, the first user slot wins; 1 — only a header
    slot matches, a miss; 2 — one user slot; 3 — a random query, a miss.
    Returns the operands and the expected slot of each row."""
    rng = np.random.default_rng(seed)
    klo, khi, vlo, vhi = (u32(rng, (n_rows, 512)) for _ in range(4))
    q = u32(rng, (n_rows, 2))
    m = np.full((n_rows, 2), 0xFFFFFFFF, np.uint32)
    ids = rng.integers(0, 2048, n_rows).astype(np.uint32)
    seeds = (7 + rng.integers(0, 16, n_rows)).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    want = np.full(n_rows, 512, np.int64)
    for i in range(n_rows):
        kind = i % 4
        if kind == 3:
            continue
        s = int(rng.integers(8, 511)) if kind != 1 else int(rng.integers(8))
        q[i] = [klo[i, s] ^ s_lo[i, s], khi[i, s] ^ s_hi[i, s]]
        extra = [int(rng.integers(8)), int(rng.integers(s + 1, 512))] \
            if kind == 0 else []
        for e in extra:                       # the same stored key again
            klo[i, e] = q[i, 0] ^ s_lo[i, e]
            khi[i, e] = q[i, 1] ^ s_hi[i, e]
        if kind != 1:
            want[i] = s
    return ([words_to_tensor(a, dev)
             for a in (klo, khi, vlo, vhi, q, m, ids, seeds)], want)


def check_lookup_hits(plain, want):
    """The plain version finds exactly the planted first user slots, and
    every planted row (header-only misses too) has a nonzero bitmap."""
    bm, _, slots = (tensor_to_words(t) for t in plain)
    if not np.array_equal(slots.astype(np.int64), want):
        raise AssertionError(f"lookup slots {slots} != planted {want}")
    rows = np.arange(len(want)) % 4 != 3
    if not bm[rows].any(axis=1).all():
        raise AssertionError("a planted lookup row has an empty bitmap")


def search_bound(n_pages, n_queries):
    ops = (n_pages * 512 * STREAM_OPS + n_queries * n_pages * 512 * MATCH_OPS
           + n_queries * n_pages * 16)                        # + ballots
    nbytes = (2 * n_pages * 512 * 4 + 2 * n_queries * 2 * 4 + 2 * n_pages * 4
              + n_queries * n_pages * 16 * 4)
    return ops, nbytes


def gather_bound(bitmap, max_out):
    bm = tensor_to_words(bitmap).astype(np.uint64)
    counts = np.array([bin(int(lo) | (int(hi) << 32)).count("1")
                       for lo, hi in bm])
    n = bm.shape[0]
    ops = n * 64 * 4                          # shift, test, popcount, compare
    nbytes = (n * 8 + int(np.minimum(counts, max_out).sum()) * 64
              + n * max_out * 64 + n * 4)
    return ops, nbytes


def lookup_bound(n_rows, slots):
    hits = int((tensor_to_words(slots) < 512).sum())
    ops = n_rows * 512 * (STREAM_OPS + MATCH_OPS) + n_rows * 16
    nbytes = (2 * n_rows * 512 * 4 + 2 * n_rows * 2 * 4 + 2 * n_rows * 4
              + hits * 64 + n_rows * (64 + 64 + 4))
    return ops, nbytes


def plan_groups(keys, rng, kind):
    """Plan groups over (N, 512) 64-bit domain keys whose page 0 slots
    100..163 hold ``base + 0..63``, and the planted (group, slot) cells on
    page 0 that must be set and cleared.

    ``check``: an exact range around ``base`` with an exclude block on
    slot 102, a group of exclude passes only (no include: all zero), an
    approximate range and an all-PAD group.  ``replay``: one exact range
    of 100 keys, the replay's scan shape.  ``work``: two exact ranges
    2^40 wide, about 90 passes each (exact 64-bit plans)."""
    base = int(keys[0, 100])
    if kind == "check":
        return ([RangePlan(exact_range(base + 1, base + 49).include,
                           exact_range(base + 2, base + 3).include),
                 RangePlan((), exact_range(base, base + 4).include),
                 approximate_range(base, base + 40), RangePlan(())],
                [(0, 101)], [(0, 102), (1, 101)])
    if kind == "replay":
        return [exact_range(base + 1, base + 101)], [(0, 101)], [(0, 100)]
    return ([exact_range(base - int(rng.integers(2**39, 2**40)),
                         base + int(rng.integers(2**39, 2**40)))
             for _ in range(2)], [(0, 101), (1, 101)], [])


def plan_case(dev, n_pages, p_pad, kind, seed):
    """Random domain keys with a planted run on page 0, the ``kind`` plan
    groups as pass rows padded to ``p_pad`` (PASS_PAD rows), and the
    stored planes randomized by the §IV-C1 stream.  Returns the operands,
    the expected bits from direct evaluation of the plans on the keys,
    and the planted set / cleared cells."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**48, (n_pages, 512), dtype=np.uint64)
    keys[0, 100:164] = (int(rng.integers(2**41, 2**47))
                        + np.arange(64, dtype=np.uint64))
    plans, set_cells, clear_cells = plan_groups(keys, rng, kind)
    q = np.zeros((len(plans), p_pad, 2), np.uint32)
    m, f = np.zeros_like(q), np.zeros((len(plans), p_pad), np.uint32)
    for g, plan in enumerate(plans):
        cmd = Command.plan(0, plan.include, plan.exclude)
        q[g], m[g], f[g] = plan_pass_rows(cmd.plan_include, cmd.plan_exclude,
                                          p_pad)
    ids = rng.integers(0, 2048, n_pages).astype(np.uint32)
    seeds = (7 + rng.integers(0, 16, n_pages)).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ s_lo
    hi = (keys >> np.uint64(32)).astype(np.uint32) ^ s_hi
    want = np.stack([plan.evaluate(keys) for plan in plans])
    return ([words_to_tensor(a, dev) for a in (lo, hi, q, m, f, ids, seeds)],
            want, set_cells, clear_cells)


def check_plan_hits(plain, want, set_cells, clear_cells):
    """The plain version's bits equal direct evaluation of the plans, the
    planted include hits are set, the excluded ones cleared, and each
    group with an include pass has hits: not a comparison of empty maps."""
    bits = np.unpackbits(tensor_to_words(plain).view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)
    if not np.array_equal(bits, want):
        raise AssertionError("plain plan bitmaps differ from direct "
                             "evaluation of the plans")
    for g, s in set_cells:
        if not bits[g, 0, s]:
            raise AssertionError(f"planted plan hit {(g, s)} missing")
    for g, s in clear_cells:
        if bits[g, 0, s]:
            raise AssertionError(f"excluded plan cell {(g, s)} is set")


def plan_bound(flags, n_pages):
    """Work of one launch: the stream once per (page, slot), the real
    (non-PAD) passes per slot, the combine and ballots per (group, page)."""
    f = tensor_to_words(flags)
    n_groups, p_pad = f.shape
    real = int((f != 0).sum())
    ops = (n_pages * 512 * STREAM_OPS + real * n_pages * 512 * PASS_OPS
           + n_groups * n_pages * (512 + 16))
    nbytes = (2 * n_pages * 512 * 4 + n_groups * p_pad * 5 * 4
              + 2 * n_pages * 4 + n_groups * n_pages * 16 * 4)
    return ops, nbytes


def bound(ops, nbytes):
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_checks(dev) -> dict:
    """Each kernel against its plain version on the card; times at the
    main path's largest burst shapes (64 queries, 64 pages or rows)."""
    rows = {}

    err = 0
    for n_pages, n_queries in ((64, 64), (70, 5)):
        args, planted = search_case(dev, n_pages, n_queries,
                                    n_pages + n_queries)
        plain = sim_search_ref(*args, randomized=True)
        check_search_hits(plain, planted)
        err = max(err, max_abs_err([sim_search(*args, randomized=True)],
                                   [plain]))
    args, _ = search_case(dev, 64, 64, 1)
    rows["sim_search"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_search(*args, randomized=True), 200),
        plain_ms=device_ms(lambda: sim_search_ref(*args, randomized=True),
                           20),
        shape="Q=64 x N=64, randomized, planted hits",
        bound=bound(*search_bound(64, 64)))

    err = 0
    for max_out in (64, 4):
        chunks, bm = gather_case(dev, 64, max_out)
        err = max(err, max_abs_err(sim_gather(chunks, bm, max_out),
                                   sim_gather_ref(chunks, bm, max_out)))
    chunks, bm = gather_case(dev, 64, 2)
    rows["sim_gather"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_gather(chunks, bm, 64), 200),
        plain_ms=device_ms(lambda: sim_gather_ref(chunks, bm, 64), 20),
        shape="N=64, max_out=64, ~32 chunks selected a row (one 0, one 64)",
        bound=bound(*gather_bound(bm, 64)))

    err = 0
    for n_rows in (64, 13):
        args, want = lookup_case(dev, n_rows, n_rows)
        plain = sim_lookup_ref(*args, randomized=True)
        check_lookup_hits(plain, want)
        err = max(err, max_abs_err(sim_fused_lookup(*args, randomized=True),
                                   plain))
    args, want = lookup_case(dev, 64, 3)
    slots = sim_fused_lookup(*args, randomized=True)[2]
    rows["sim_lookup"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_fused_lookup(*args, randomized=True), 200),
        plain_ms=device_ms(lambda: sim_lookup_ref(*args, randomized=True),
                           20),
        shape=f"B=64 rows, randomized, {int((want < 512).sum())} hits",
        bound=bound(*lookup_bound(64, slots)))

    err = 0
    for n_pages, p_pad, kind in ((32, 16, "check"), (64, 128, "check"),
                                 (70, 16, "check"), (32, 16, "replay"),
                                 (64, 128, "work")):
        args, want, set_cells, clear_cells = plan_case(
            dev, n_pages, p_pad, kind, n_pages + p_pad)
        plain = sim_plan_ref(*args, randomized=True)
        check_plan_hits(plain, want, set_cells, clear_cells)
        err = max(err, max_abs_err([sim_plan(*args, randomized=True)],
                                   [plain]))
    timed = {}
    for n_pages, p_pad, kind in ((32, 16, "replay"), (64, 128, "work")):
        args, _, _, _ = plan_case(dev, n_pages, p_pad, kind, 5)
        timed[kind] = dict(
            ms=device_ms(lambda: sim_plan(*args, randomized=True), 200),
            plain_ms=device_ms(lambda: sim_plan_ref(*args, randomized=True),
                               10),
            bound=bound(*plan_bound(args[4], n_pages)))
        log(f"kernel sim_plan [{kind}: G={args[2].shape[0]}, P={p_pad}, "
            f"N={n_pages}]: {timed[kind]['ms']:.6f} ms/launch, plain "
            f"{timed[kind]['plain_ms']:.6f} ms, bound "
            f"{timed[kind]['bound'][0]:.6f} ms ({timed[kind]['bound'][1]})")
    rows["sim_plan"] = dict(
        max_abs_err=err, **timed["replay"],
        shape="replay scan: G=1, P=16, N=32, randomized, planted hits",
        work=timed["work"])

    for name, r in rows.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {r['max_abs_err']})")
        log(f"kernel {name} [{r['shape']}]: bit-exact vs plain; "
            f"{r['ms']:.6f} ms/launch, plain {r['plain_ms']:.6f} ms, "
            f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]})")
    return rows


# --------------------------------------------------------------- phase 3
class TimedBackend(BatchedKernelBackend):
    """The batched backend, timing the bulk load that replay() opens with
    (its first ``n_load`` page programs) apart from the replayed ops."""

    def __init__(self, chips, n_load: int, **kw):
        super().__init__(chips, **kw)
        self.n_load = n_load
        self.load_s = 0.0

    def program_entries(self, page_addr, entries, **kw):
        if self.n_load <= 0:
            return super().program_entries(page_addr, entries, **kw)
        self.n_load -= 1
        t0 = time.perf_counter()
        built = super().program_entries(page_addr, entries, **kw)
        self.load_s += time.perf_counter() - t0
        return built


def oracle(wl, n_key_pages):
    """Serial semantics in plain numpy: reads see the latest write; a scan
    of key ids [k, k + len) counts the stored keys it covers, clipped to
    the index, and leaves values alone."""
    n_keys = n_key_pages * KEYS_PER_PAGE
    values = (np.arange(1, n_keys + 1, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    out = np.zeros(len(wl.ops), np.uint64)
    counts = np.zeros(len(wl.ops), np.int64)
    for qi, (op, k) in enumerate(zip(wl.ops, wl.keys)):
        if op == 0:
            out[qi] = values[k]
        elif op == 1:
            values[k] = np.uint64(qi * 2 + 1)
        else:
            counts[qi] = min(k + 1 + int(wl.scan_lens[qi]), n_keys + 1) \
                - (k + 1)
    return out, counts


def run_replay(label, wl, n_key_pages, n_chips, config):
    """One path: fresh chips, launch counts and peak device memory set to
    0 just before the replay and read just after it."""
    pages_per_chip = -(-2 * n_key_pages // n_chips) + 1
    chips = SimChipArray(n_chips=n_chips, pages_per_chip=pages_per_chip,
                         device_seed=7)
    backend = TimedBackend(chips, n_load=2 * n_key_pages)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    rep = replay(wl, backend, config)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ops_s = len(wl.ops) / (wall_s - backend.load_s)
    log(f"replay {label}: wall {wall_s:.3f} s (bulk load of "
        f"{2 * n_key_pages} pages {backend.load_s:.3f} s), {ops_s:.1f} ops/s "
        f"after the load; reads {rep.n_reads}, writes {rep.n_writes}, scans "
        f"{rep.n_scans}; flushes {rep.flushes}, kernel_launches "
        f"{rep.kernel_launches}, launches by kernel {grew}, staged_bytes "
        f"{rep.staged_bytes}, result_bytes {rep.result_bytes}, programs "
        f"{rep.programs}, write_flushes {rep.write_flushes}, "
        f"buffer_read_hits {rep.buffer_read_hits}, resident rows "
        f"{backend.store.resident_rows}, peak device memory {peak} bytes")
    return rep, grew, backend, peak


def check_replay(label, wl, rep, grew, config, n_key_pages):
    """Values and scan counts equal the oracle; the launches by kernel add
    up to the backend's count; one ``sim_plan`` launch a scan."""
    want, counts = oracle(wl, n_key_pages)
    reads, scans = wl.ops == 0, wl.ops == 2
    if not rep.read_hits[reads].all():
        raise AssertionError(f"{label}: a read missed its key")
    if not np.array_equal(rep.read_values[reads], want[reads]):
        raise AssertionError(f"{label}: read values differ from the oracle")
    if scans.any() and not np.array_equal(rep.scan_counts[scans],
                                          counts[scans]):
        raise AssertionError(f"{label}: scan counts differ from the oracle")
    if (rep.n_scans, grew["sim_plan"]) != (int((counts[scans] > 0).sum()),) * 2:
        raise AssertionError(f"{label}: {grew['sim_plan']} sim_plan launches "
                             f"and {rep.n_scans} scans for "
                             f"{int(scans.sum())} scan ops")
    if sum(grew.values()) != rep.kernel_launches:
        raise AssertionError(f"{label}: launches by kernel {grew} do not add "
                             f"up to kernel_launches {rep.kernel_launches}")
    if config.fused and rep.kernel_launches != rep.flushes:
        raise AssertionError(f"{label}: {rep.kernel_launches} launches for "
                             f"{rep.flushes} flushes")
    if config.write_buffer and not (
            rep.buffer_read_hits > 0 and rep.write_flushes > 0
            and rep.programs < rep.n_writes):
        raise AssertionError(f"{label}: the write buffer neither served "
                             "reads nor coalesced writes")


def check_scan_plans(backend, wl, rep, n_key_pages, n_scans):
    """The first scans again on the replay's backend: the fused PLAN
    bitmaps equal the per-pass searches combined on the host
    (``sim_search`` on the card), and count the replay's scan counts."""
    n_keys = n_key_pages * KEYS_PER_PAGE
    for qi in np.nonzero(wl.ops == 2)[0][:n_scans]:
        lo = int(wl.keys[qi]) + 1
        hi = min(lo + int(wl.scan_lens[qi]), n_keys + 1)
        pages = list(range((lo - 1) // KEYS_PER_PAGE,
                           min((hi - 2) // KEYS_PER_PAGE, n_key_pages - 1)
                           + 1))
        plan = exact_range(lo, hi, width=64)
        fused = evaluate_plan_on_pages(backend, plan, pages)
        if not np.array_equal(fused,
                              evaluate_plan_per_pass(backend, plan, pages)):
            raise AssertionError(f"scan {qi}: PLAN differs from per-pass")
        total = int(np.unpackbits(mask_header_slots(fused).view(np.uint8))
                    .sum())
        if total != rep.scan_counts[qi]:
            raise AssertionError(f"scan {qi}: {total} keys, replay counted "
                                 f"{rep.scan_counts[qi]}")


def main_path(kp, n_ops) -> dict:
    """Four replays at full width on 16 chips, each path's launch counts
    set to 0 just before it and read just after it; returns the launches
    by kernel summed over the paths."""
    n_chips = 16

    def ycsb(**kw):
        return generate(n_ops, n_key_pages=kp, alpha=0.9, seed=1, **kw)

    ycsb_b = ycsb(read_ratio=0.95)
    paths = [
        ("YCSB-B split", ycsb_b, RunConfig(burst=64)),
        ("YCSB-B fused", ycsb_b, RunConfig(burst=64, fused=True)),
        ("YCSB-E scans fused", ycsb(read_ratio=0.0, scan_ratio=0.95,
                                    max_scan_len=100),
         RunConfig(burst=64, fused=True)),
        ("YCSB-A write buffer fused", ycsb(read_ratio=0.5),
         RunConfig(burst=64, fused=True, write_buffer=True,
                   write_high_water=16)),
    ]
    launches = {k: 0 for k in native.LAUNCHES}
    reports, peaks = {}, []
    for label, wl, config in paths:
        rep, grew, backend, peak = run_replay(label, wl, kp, n_chips, config)
        peaks.append(peak)
        check_replay(label, wl, rep, grew, config, kp)
        if rep.n_scans:
            check_scan_plans(backend, wl, rep, kp, 200)
        del backend
        reports[label] = rep
        for k in launches:
            launches[k] += grew[k]
    split, fused = reports["YCSB-B split"], reports["YCSB-B fused"]
    if not (np.array_equal(split.read_values, fused.read_values)
            and np.array_equal(split.read_hits, fused.read_hits)):
        raise AssertionError("YCSB-B split and fused replays disagree")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} never launched on the main path")
    log(f"peak device memory {max(peaks)} bytes (the largest path's)")
    log("replays: read values and scan counts equal the numpy oracle, all "
        "reads hit, YCSB-B split and fused agree, launches by kernel add up "
        "to kernel_launches, one sim_plan launch a scan, fused launches == "
        "flushes, the first 200 scans' PLAN bitmaps equal the per-pass "
        "searches")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--key-pages", type=int, default=16_384)
    ap.add_argument("--n-ops", type=int, default=20_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. Device and build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s -> {lib.name}")

    # 2. Kernel checks (these launches are not the main path's).
    rows = kernel_checks(dev)

    # 3. The main path.
    launches = main_path(args.key_pages, args.n_ops)

    # 4. Kernels line.
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": None}
        for k, r in rows.items()]}), flush=True)
    # 5. The card, then the result.
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
