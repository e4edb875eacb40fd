"""The port's sharded SSD backend and flash timeline against the JAX
package's, bit for bit.

Both packages run on the CPU: the port with ``device="cpu"`` (the plain
PyTorch versions of its kernels, the chip-axis forms included), the JAX
package as its own tests run it — its Pallas kernels in interpret mode for
the kernel-level and flush-level cases, ``use_kernel=False`` for the
replays.  Responses, ``BackendStats``, per-chip counters and the
timeline's latencies and energy must agree exactly (tolerance 0: the
timeline does the same float64 numpy arithmetic in the same order).
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import ShardedSsdBackend as JSharded
from repro.backend import make_backend as jmake_backend
from repro.backend.sharded import _stacked_plan, _stacked_search
from repro.backend.sharded import compose as jcompose
from repro.backend.sharded import decompose as jdecompose
from repro.core.commands import Command as JCommand
from repro.core.commands import Op as JOp
from repro.core.engine import SimChipArray as JSimChipArray
from repro.flash.timeline import BurstTimeline as JBurstTimeline
from repro.flash.timeline import ChipBurst as JChipBurst
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.index.btree import SimBTree as JSimBTree
from repro.index.hashindex import SimHashIndex as JSimHashIndex
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import (BackendStats, ShardedSsdBackend,
                                 make_backend)
from repro_torch.backend.sharded import (SHARDED_LOOKUP_BLOCK, compose,
                                         decompose)
from repro_torch.core.bitweaving import Column, RowCodec
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.range_query import approximate_range, exact_range
from repro_torch.flash.timeline import BurstTimeline, ChipBurst
from repro_torch.frontend import RunConfig, replay
from repro_torch.index.btree import SimBTree
from repro_torch.index.hashindex import SimHashIndex
from repro_torch.index.secondary import SimSecondaryIndex
from repro_torch.kernels.layout import tensor_to_words, words_to_tensor
from repro_torch.kernels.sim_plan.ref import plan_pass_rows
from repro_torch.kernels.sim_plan.ops import sim_plan_chips
from repro_torch.kernels.sim_search.ops import sim_search_chips
from repro_torch.workload.ycsb import generate

N_PAGES = 16
ENTRIES = 250
FULL = 2**64 - 1
STATS = [f.name for f in dataclasses.fields(BackendStats)]
GEOMETRIES = [(1, 1), (2, 2), (4, 4), (8, 2)]


def _jcmd(c):
    return JCommand(JOp(c.op.value), c.page_addr, query=c.query, mask=c.mask,
                    chunk_bitmap=c.chunk_bitmap, value_page=c.value_page,
                    plan_include=c.plan_include, plan_exclude=c.plan_exclude)


def _same(a, b):
    """Two responses equal field for field (arrays by value)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same(x, y)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _same_stats(a, b):
    assert {k: getattr(a.stats, k) for k in STATS} == \
        {k: getattr(b.stats, k) for k in STATS}
    for c, d in zip(a.chips.chips, b.chips.chips):
        assert vars(c.counters) == vars(d.counters)


def _page_keys(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 2**62, ENTRIES, dtype=np.uint64)
            for _ in range(N_PAGES)]


def _pair(channels, dies, page_keys, **kw):
    """(port, JAX) sharded backends of one geometry, identically loaded."""
    per_chip = max(N_PAGES // (channels * dies), 1) + 1
    port = ShardedSsdBackend.from_geometry(
        channels=channels, dies_per_channel=dies, pages_per_chip=per_chip,
        device_seed=31, device="cpu", **kw)
    ref = JSharded.from_geometry(
        channels=channels, dies_per_channel=dies, pages_per_chip=per_chip,
        device_seed=31, **kw)
    for p, keys in enumerate(page_keys):
        port.program_entries(p, keys)
        ref.program_entries(p, keys)
    return port, ref


def _burst(page_keys, seed=1):
    """One mixed burst over every chip: searches (planted, masked,
    match-all, a duplicate cell), gathers (random, empty, full), lookups
    whose key and value pages sit on different chips (hits and misses) and
    plans (include, exclude, differing pass counts, a shared group)."""
    rng = np.random.default_rng(seed)
    cmds = []
    for _ in range(40):
        p = int(rng.integers(0, N_PAGES))
        if rng.random() < 0.5:
            q, m = int(page_keys[p][rng.integers(0, ENTRIES)]), FULL
        else:
            q = int(rng.integers(1, 2**62))
            m = int(rng.integers(0, 2**64, dtype=np.uint64))
        cmds.append(Command.search(p, q, m))
    cmds += [Command.search(0, 0, 0), cmds[0]]
    cmds += [Command.gather(p, int(rng.integers(0, 2**64, dtype=np.uint64)))
             for p in range(N_PAGES)]
    cmds += [Command.gather(0, 0), Command.gather(1, FULL)]
    half = N_PAGES // 2
    for _ in range(20):
        kp = int(rng.integers(0, half))
        q = int(page_keys[kp][rng.integers(0, ENTRIES)]) \
            if rng.random() < 0.7 else int(rng.integers(2**62, 2**63))
        cmds.append(Command.lookup(kp, kp + half, q))
    for p in range(0, N_PAGES, 3):
        lo = int(np.sort(page_keys[p])[40])
        cmds.append(Command.plan(p, exact_range(lo, lo + 2**58).include,
                                 exact_range(lo + 5, lo + 7).include))
        cmds.append(Command.plan(p, approximate_range(lo, lo + 2**40)
                                 .include))
    return cmds


def _flush_both(port, ref, cmds):
    tp = [getattr(port, f"submit_{c.op.value}")(c) for c in cmds]
    tr = [getattr(ref, f"submit_{c.op.value}")(_jcmd(c)) for c in cmds]
    assert port.pending == ref.pending == len(cmds)
    port.flush()
    ref.flush()
    return [t.result() for t in tp], [t.result() for t in tr]


# ------------------------------------------------------------- addressing
@pytest.mark.parametrize("n_chips", [1, 2, 3, 5, 8, 16])
def test_decompose_compose_match_jax_sweep(n_chips):
    for addr in range(0, 2000, 7):
        chip, local = decompose(addr, n_chips)
        assert (chip, local) == jdecompose(addr, n_chips)
        assert 0 <= chip < n_chips
        assert compose(chip, local, n_chips) == addr
    seen = {compose(c, p, n_chips) for c in range(n_chips) for p in range(64)}
    assert len(seen) == n_chips * 64
    assert all(compose(c, p, n_chips) == jcompose(c, p, n_chips)
               for c in range(n_chips) for p in range(64))


def test_decompose_matches_simchiparray_route():
    arr = SimChipArray(n_chips=6, pages_per_chip=8, device_seed=3)
    for addr in range(40):
        chip, local = decompose(addr, 6)
        routed_chip, routed_local = arr.route(addr)
        assert routed_chip is arr.chips[chip]
        assert routed_local == local


def test_geometry_validation():
    arr = SimChipArray(n_chips=6, pages_per_chip=8)
    with pytest.raises(ValueError):
        ShardedSsdBackend(arr, channels=4, dies_per_channel=4, device="cpu")
    be = ShardedSsdBackend(arr, channels=3, dies_per_channel=2, device="cpu")
    assert (be.channels, be.dies_per_channel, be.n_chips) == (3, 2, 6)
    jbe = JSharded(JSimChipArray(n_chips=6, pages_per_chip=8), channels=3,
                   dies_per_channel=2)
    assert (be.store.block, SHARDED_LOOKUP_BLOCK) == \
        (jbe.page_block, jbe.lookup_block) == (8, 8)
    with pytest.raises(ValueError):
        ShardedSsdBackend(SimChipArray(n_chips=4, pages_per_chip=8),
                          timeline=BurstTimeline.for_chips(16), device="cpu")
    with pytest.raises(ValueError):
        ShardedSsdBackend(SimChipArray(n_chips=4, pages_per_chip=8),
                          replicas=5, device="cpu")
    be = make_backend("sharded", SimChipArray(n_chips=8, pages_per_chip=4),
                      dies_per_channel=2, device="cpu")
    assert (be.channels, be.dies_per_channel) == (4, 2)


# ------------------------------------------------- chip-axis kernel forms
def _stacked_case(n_chips, n_pages, seed):
    """Per-chip planes (C, N, 512) with planted hits, as the JAX stacked
    launch takes them, and the same rows scattered into one arena: chip c's
    rows ``rows[c]``.  The last chip is a pad chip (all rows 0, the pad of
    the sharded backend) when C > 1, and every chip's last two rows are pad
    rows (row 0); chip 1 repeats a row of chip 0."""
    rng = np.random.default_rng(seed)
    cap = 1 + n_chips * n_pages
    a_lo = rng.integers(0, 2**32, (cap, 512), dtype=np.uint64) \
        .astype(np.uint32)
    a_hi = rng.integers(0, 2**32, (cap, 512), dtype=np.uint64) \
        .astype(np.uint32)
    a_ids = rng.integers(0, 4096, cap).astype(np.uint32)
    a_seeds = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32)
    rows = 1 + rng.permutation(cap - 1)[:n_chips * n_pages] \
        .reshape(n_chips, n_pages).astype(np.int32)
    rows[:, -2:] = 0
    if n_chips > 1:
        rows[-1] = 0
        rows[1, 0] = rows[0, 1]
    return (a_lo, a_hi, a_ids, a_seeds), rows


def _stream_words(ids, seeds, lo, hi, slot):
    from repro_torch.kernels.sim_search.ref import stream_planes
    s_lo, s_hi = stream_planes(words_to_tensor(np.atleast_1d(ids), "cpu"),
                               words_to_tensor(np.atleast_1d(seeds), "cpu"))
    return (int(lo) ^ int(s_lo[0, slot]), int(hi) ^ int(s_hi[0, slot]))


@pytest.mark.parametrize("n_chips", [1, 2, 4])
def test_search_chips_ref_matches_stacked_search(n_chips):
    n_pages, n_queries = 8, 4
    (a_lo, a_hi, a_ids, a_seeds), rows = _stacked_case(n_chips, n_pages,
                                                       n_chips)
    rng = np.random.default_rng(n_chips + 10)
    q = rng.integers(0, 2**32, (n_chips, n_queries, 2), dtype=np.uint64) \
        .astype(np.uint32)
    m = np.full_like(q, 0xFFFFFFFF)
    for c in range(n_chips):              # a planted hit on each chip
        r, s = int(rows[c, 0]), int(rng.integers(512))
        q[c, 0] = _stream_words(a_ids[r], a_seeds[r], a_lo[r, s],
                                a_hi[r, s], s)
    m[:, 1] = [0xF, 0]                    # a 4-bit mask: many hits
    q[:, -1] = m[:, -1] = 0               # a pad query: matches every slot
    got = tensor_to_words(sim_search_chips(
        *(words_to_tensor(x, "cpu") for x in (a_lo, a_hi, q, m, a_ids,
                                              a_seeds)),
        randomized=True, rows=torch.from_numpy(rows)))
    want = np.asarray(_stacked_search(
        jnp.asarray(a_lo[rows]), jnp.asarray(a_hi[rows]), jnp.asarray(q),
        jnp.asarray(m), jnp.asarray(a_ids[rows]), jnp.asarray(a_seeds[rows]),
        page_block=8, use_kernel=True, interpret=True))
    assert got.shape == (n_chips, n_queries, n_pages, 16)
    np.testing.assert_array_equal(got, want)
    assert all(got[c, 0, 0].any() for c in range(n_chips))


@pytest.mark.parametrize("n_chips", [1, 2, 4])
def test_plan_chips_ref_matches_stacked_plan(n_chips):
    n_pages, p_pad = 8, 16
    (a_lo, a_hi, a_ids, a_seeds), rows = _stacked_case(n_chips, n_pages,
                                                       20 + n_chips)
    lo, hi, ids, seeds = (a[rows] for a in (a_lo, a_hi, a_ids, a_seeds))
    base = 2**40
    # Chip c's first page holds a run of keys: plant them in the
    # randomized domain so the plans hit.
    for c in range(n_chips):
        for s in range(100, 140):
            lo[c, 0, s], hi[c, 0, s] = _stream_words(
                ids[c, 0], seeds[c, 0], (base + s) & 0xFFFFFFFF,
                (base + s) >> 32, s)
    groups = [exact_range(base + 101, base + 130),
              exact_range(base + 90, base + 140)]
    q = np.zeros((n_chips, 2, p_pad, 2), np.uint32)
    m, f = np.zeros_like(q), np.zeros((n_chips, 2, p_pad), np.uint32)
    for c in range(n_chips):
        for g, plan in enumerate(groups[:2 if c % 2 == 0 else 1]):
            inc = plan.include
            exc = exact_range(base + 110, base + 112).include if g else ()
            cmd = Command.plan(0, inc, exc)
            q[c, g], m[c, g], f[c, g] = plan_pass_rows(
                cmd.plan_include, cmd.plan_exclude, p_pad)
    got = tensor_to_words(sim_plan_chips(
        *(words_to_tensor(x, "cpu") for x in (lo, hi, q, m, f, ids, seeds)),
        randomized=True))
    want = np.asarray(_stacked_plan(
        *(jnp.asarray(x) for x in (lo, hi, q, m, f, ids, seeds)),
        page_block=8, use_kernel=True, interpret=True))
    assert got.shape == (n_chips, 2, n_pages, 16)
    np.testing.assert_array_equal(got, want)
    assert all(got[c, 0, 0].any() for c in range(n_chips))
    assert not got[1::2, 1].any()           # all-PAD groups match nothing


# ---------------------------------------------------- backend parity
@pytest.fixture(scope="module")
def page_keys():
    return _page_keys()


@pytest.mark.parametrize("channels,dies", GEOMETRIES)
def test_mixed_burst_identical_to_jax(page_keys, channels, dies):
    """Searches, plans, lookups and gathers of one burst over every chip:
    equal responses, one launch a phase, equal stats and chip counters."""
    port, ref = _pair(channels, dies, page_keys)
    got, want = _flush_both(port, ref, _burst(page_keys))
    for a, b in zip(got, want):
        _same(a, b)
    assert port.stats.kernel_launches == 4 == port.stats.flushes * 4
    _same_stats(port, ref)
    misses = sum(r.value_slot is None for r in got
                 if hasattr(r, "value_slot"))
    assert 0 < misses < 20


@pytest.mark.parametrize("channels,dies", GEOMETRIES)
def test_bursts_of_one_kind_identical_to_jax(page_keys, channels, dies):
    """Bursts of a single phase (one launch each) and a reprogram between
    them, against the JAX backend and across geometries."""
    port, ref = _pair(channels, dies, page_keys)
    cmds = _burst(page_keys, seed=channels * 10 + dies)
    for kind in ("search", "gather", "lookup", "plan"):
        batch = [c for c in cmds if c.op.value == kind]
        before = port.stats.kernel_launches
        got, want = _flush_both(port, ref, batch)
        assert port.stats.kernel_launches == before + 1
        for a, b in zip(got, want):
            _same(a, b)
        if kind == "gather":
            keys = page_keys[5][::-1].copy()
            port.program_entries(5, keys)
            ref.program_entries(5, keys)
    _same_stats(port, ref)


def test_reprogram_restages_one_row_and_logs_it(page_keys):
    port, ref = _pair(4, 4, page_keys)
    for be, cmd in ((port, Command.search(5, int(page_keys[5][0]))),
                    (ref, _jcmd(Command.search(5, int(page_keys[5][0]))))):
        be.search(cmd)
    warm = port.stats.staged_bytes
    assert port.store.staged_log == ref.store.staged_log == []
    new_keys = page_keys[5][::-1].copy()
    for be in (port, ref):
        be.program_entries(5, new_keys)
    got = port.search(Command.search(5, int(new_keys[3])))
    want = ref.search(_jcmd(Command.search(5, int(new_keys[3]))))
    _same(got, want)
    assert got.match_count >= 1
    assert port.stats.staged_bytes - warm == 4096
    _same_stats(port, ref)


def test_staging_log_skips_cold_rows_and_logs_dirty_ones():
    from repro.backend.planestore import PlaneStore as JPlaneStore
    from repro_torch.backend import PlaneStore
    rng = np.random.default_rng(2)
    keys = [rng.integers(1, 2**62, 40, dtype=np.uint64) for _ in range(6)]
    stores = []
    for arr_cls, store_cls, kw in ((SimChipArray, PlaneStore,
                                    dict(device="cpu")),
                                   (JSimChipArray, JPlaneStore, {})):
        arr = arr_cls(n_chips=3, pages_per_chip=4, device_seed=5)
        for p, k in enumerate(keys):
            arr.program_entries(p, k)
        quiet = store_cls(arr, block=8, **kw)
        store = store_cls(arr, block=8, log_staging=True, **kw)
        store.rows_for([0, 1, 2, 1])           # cold: staged, not logged
        assert store.staged_log == [] and store.staged_rows == 3
        arr.program_entries(1, keys[1][::-1].copy())
        arr.program_entries(2, keys[2][::-1].copy())
        store.rows_for([3, 2, 1, 2])           # 3 cold, 2 and 1 dirty
        store.stage_group([1, 4])              # clean 1 skipped, 4 cold
        quiet.rows_for([0, 1])
        arr.program_entries(0, keys[0][::-1].copy())
        quiet.rows_for([0])
        assert quiet.staged_log == []
        stores.append(store)
    assert stores[0].staged_log == stores[1].staged_log == [2, 1]
    assert stores[0].staged_bytes == stores[1].staged_bytes == 7 * 4096


def test_upload_rows2d_checks_rows_and_uploads_once():
    from repro_torch.backend import PlaneStore
    arr = SimChipArray(n_chips=2, pages_per_chip=4)
    for p in range(3):
        arr.program_entries(p, np.arange(1, 9, dtype=np.uint64) + 8 * p)
    store = PlaneStore(arr, block=8, device="cpu")
    store.rows_for([2, 0, 1])
    idx = store.upload_rows2d(np.array([[1, 2, 0], [0, 0, 0]]))
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (2, 3)
    np.testing.assert_array_equal(idx.numpy(), [[1, 2, 0], [0, 0, 0]])
    with pytest.raises(IndexError):
        store.upload_rows2d(np.array([[3]]))
    with pytest.raises(IndexError):
        store.upload_rows2d(np.array([[-1]]))
    with pytest.raises(ValueError):
        store.upload_rows2d(np.array([0, 1]))


def test_lazy_tail_survives_reprogram_between_flush_and_drain(page_keys):
    """The chip-axis search reads the arena in place: a reprogram after the
    flush and before the drain must not reach the flushed burst."""
    port, ref = _pair(4, 4, page_keys)
    cmd = Command.search(5, int(page_keys[5][7]))
    t = port.submit_search(cmd)
    port.flush()
    new_keys = page_keys[5][::-1].copy()
    port.program_entries(5, new_keys)
    port.search(Command.search(5, int(new_keys[0])))
    _same(t.result(), ref.search(_jcmd(cmd)))


def test_replicas_program_every_copy_identical_to_jax(page_keys):
    port, ref = _pair(2, 2, page_keys[:6], replicas=2, timeline=True)
    assert port._replica_of == ref._replica_of and len(port._replica_of) == 6
    for p, reps in port._replica_of.items():
        assert [r % 4 for r in reps] == [(p + 1) % 4]
    for a, b in zip(port.chips.chips, ref.chips.chips):
        assert sorted(a.pages) == sorted(b.pages)
    # Deferred programs fan out as well, and land on the timeline.
    for be in (port, ref):
        be.submit_program(2, page_keys[9])
        be.submit_program(7, page_keys[10])
        be.flush()
    assert port._replica_of == ref._replica_of
    assert port.timeline.write_latencies == ref.timeline.write_latencies
    # A replica holds the primary's entries: equal search responses.
    rep = port._replica_of[2][0]
    for addr in (rep, 2):
        cmd = Command.search(addr, int(page_keys[9][5]))
        got = port.search(cmd)
        assert got.match_count == 1
        _same(got, ref.search(_jcmd(cmd)))
    _same_stats(port, ref)


# The name is from before slice 7, when this path raised; it is kept so
# the test's ID stays stable across the port's slices.
def test_device_faults_and_timeline_faults_raise_slice_7():
    """The device-fault and reliability hooks are ported: the fault state
    attaches to the backend and its timeline, the reliability state to
    the backend, and a stalled, reliable flush equals the JAX backend's
    (responses, stats, burst latencies)."""
    from repro.reliability import DeviceFaultState as JDeviceFaultState
    from repro.reliability import FaultSchedule as JFaultSchedule
    from repro.reliability import ReliabilityState as JReliabilityState
    from repro_torch.reliability import (DeviceFaultState, FaultSchedule,
                                         ReliabilityState)

    be = ShardedSsdBackend.from_geometry(channels=2, pages_per_chip=4,
                                         timeline=True, device="cpu")
    ref = JSharded.from_geometry(channels=2, pages_per_chip=4,
                                 timeline=True, use_kernel=False)
    sched = dict(die=1, t_start_ms=0.0, dur_ms=0.5, seed=3)
    state = DeviceFaultState(FaultSchedule.transient_stall(**sched))
    be.enable_device_faults(state)
    ref.enable_device_faults(JDeviceFaultState(
        JFaultSchedule.transient_stall(**sched)))
    assert be.faults is state and be.timeline.faults is state
    rel = ReliabilityState()
    be.enable_reliability(rel)
    ref.enable_reliability(JReliabilityState())
    assert be.reliability is rel
    keys = np.arange(10, 30, dtype=np.uint64)
    for b in (be, ref):
        for p in range(4):
            b.program_entries(p, keys + 100 * p)
        b.timeline.reset()
    cmds = [Command.search(p, int(keys[2] + 100 * p)) for p in range(4)]
    tickets = [be.submit_search(c) for c in cmds]
    jtickets = [ref.submit_search(_jcmd(c)) for c in cmds]
    be.flush()
    ref.flush()
    for t, jt in zip(tickets, jtickets):
        _same(t.result(), jt.result())
    _same_stats(be, ref)
    assert be.timeline.burst_latencies == ref.timeline.burst_latencies
    assert be.timeline.burst_latencies[0] > 0.5e6   # queued behind the stall


# -------------------------------------------------------------- timeline
def test_timeline_resource_accounting_identical_to_jax():
    results = []
    for tl_cls, burst in ((BurstTimeline, ChipBurst),
                          (JBurstTimeline, JChipBurst)):
        tl = tl_cls.for_chips(4)
        lat_parallel = tl.observe_flush(
            [burst(c, senses=1, matches=2, bus_match_bytes=128,
                   pcie_bytes=64) for c in range(4)])
        assert tl.sim.stats.senses == 4 and tl.sim.stats.matches == 8
        tl2 = tl_cls(tl.params)
        lat_serial = tl2.observe_flush(
            [burst(0, senses=4, matches=8, bus_match_bytes=512,
                   pcie_bytes=256, bus_storage_bytes=4096)],
            wait_program_lines=True)
        assert lat_serial > lat_parallel
        w = [tl.observe_program(2), tl.observe_program(2, at=5e4)]
        g = tl.observe_program_group([0, 1, 1], restage_chips=[1])
        results.append((lat_parallel, lat_serial, w, g, tl.now,
                        tl.energy_pj, tl.latency_percentiles(),
                        tl.burst_latencies, tl.write_latencies,
                        tl2.energy_pj, vars(tl.sim.stats)))
    assert results[0] == results[1]
    for n in (1, 2, 3, 4, 6, 8, 16, 24):
        assert (dataclasses.asdict(BurstTimeline.for_chips(n).params)
                == dataclasses.asdict(JBurstTimeline.for_chips(n).params))


def test_timeline_charges_bus_writeback_only_for_dirty_planes():
    """Cold first-touch staging is no SSD channel traffic: a read-only
    replay accrues zero storage-mode bus bytes, while a reprogram charges
    one page's write-back crossing — the same timeline as the JAX one."""
    rng = np.random.default_rng(3)
    keys = [rng.integers(1, 2**62, 50, dtype=np.uint64) for _ in range(8)]
    lats = []
    for be, cmd in ((ShardedSsdBackend.from_geometry(
            channels=2, dies_per_channel=2, pages_per_chip=8, timeline=True,
            device="cpu"), Command.search),
                    (JSharded.from_geometry(
                        channels=2, dies_per_channel=2, pages_per_chip=8,
                        timeline=True), JCommand.search)):
        for p, k in enumerate(keys):
            be.program_entries(p, k)
        be.timeline.reset()
        bus0 = be.timeline.sim.stats.internal_bytes
        for p in range(8):                  # cold first-touch searches
            be.search(cmd(p, int(keys[p][0])))
        assert be.timeline.sim.stats.internal_bytes - bus0 == 8 * (256 + 64)
        before = list(be.timeline.burst_latencies)
        be.program_entries(3, keys[3][::-1].copy())
        be.search(cmd(3, int(keys[3][-1])))
        assert len(be.timeline.burst_latencies) == len(before) + 1
        assert be.timeline.burst_latencies[-1] > np.median(before)
        lats.append((be.timeline.burst_latencies, be.timeline.energy_pj,
                     be.timeline.sim.stats.internal_bytes))
    assert lats[0] == lats[1]


# ------------------------------------------------------------- workloads
REPORT_ARRAYS = ("read_values", "read_hits", "burst_latencies_ns",
                 "write_latencies_ns")
REPORT_SCALARS = ("sim_makespan_ns", "sim_energy_pj", "flushes",
                  "kernel_launches", "staged_bytes", "result_bytes",
                  "programs", "write_flushes", "buffer_read_hits")


def _replay_pair(wl, jwl, channels, dies, config, jconfig):
    per_chip = max(wl.n_index_pages // (channels * dies) + 1, 8)
    got = replay(wl, ShardedSsdBackend.from_geometry(
        channels=channels, dies_per_channel=dies, pages_per_chip=per_chip,
        device_seed=3, timeline=True, device="cpu"), config)
    want = jreplay(jwl, JSharded.from_geometry(
        channels=channels, dies_per_channel=dies, pages_per_chip=per_chip,
        device_seed=3, timeline=True, use_kernel=False), jconfig)
    return got, want


def _same_report(got, want):
    for f in REPORT_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in REPORT_SCALARS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.fixture(scope="module")
def ycsb():
    kw = dict(n_key_pages=6, read_ratio=0.8, alpha=0.5, seed=11)
    return generate(240, **kw), jgenerate(240, **kw)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("channels,dies", [(1, 1), (4, 4)])
def test_ycsb_replay_and_timeline_identical_to_jax(ycsb, channels, dies,
                                                   fused):
    """Values, counters and the timeline's burst and write latencies,
    makespan and energy exactly equal to the JAX package's replay."""
    wl, jwl = ycsb
    got, want = _replay_pair(wl, jwl, channels, dies,
                             RunConfig(burst=32, fused=fused),
                             JRunConfig(burst=32, fused=fused))
    _same_report(got, want)
    assert got.read_hits[wl.ops == 0].all()
    assert len(got.burst_latencies_ns) == got.flushes
    assert (got.burst_latencies_ns > 0).all() and got.sim_energy_pj > 0
    assert got.kernel_launches == (1 if fused else 2) * (
        got.flushes // (1 if fused else 2))


def test_buffered_scan_replay_on_8x2_identical_to_jax():
    """YCSB-E scans (one chip-axis plan launch a scan) and YCSB-A through
    the write buffer on the paper's 8 x 2 geometry, timeline included."""
    for kw, cfg in ((dict(read_ratio=0.0, scan_ratio=0.9, max_scan_len=40),
                     dict(burst=16, fused=True)),
                    (dict(read_ratio=0.5), dict(
                        burst=16, fused=False, write_buffer=True,
                        write_high_water=4))):
        wl = generate(150, n_key_pages=8, alpha=0.9, seed=5, **kw)
        jwl = jgenerate(150, n_key_pages=8, alpha=0.9, seed=5, **kw)
        got, want = _replay_pair(wl, jwl, 8, 2, RunConfig(**cfg),
                                 JRunConfig(**cfg))
        _same_report(got, want)
        if got.n_scans:
            np.testing.assert_array_equal(got.scan_counts, want.scan_counts)
            assert got.kernel_launches == got.flushes == got.n_scans
        else:
            assert got.write_flushes > 0 and got.buffer_read_hits > 0


def test_die_channel_parallelism(ycsb):
    """The same op stream finishes sooner on 16 dies than on 1."""
    wl, _ = ycsb
    reps = []
    for channels, dies in ((1, 1), (4, 4)):
        reps.append(replay(wl, ShardedSsdBackend.from_geometry(
            channels=channels, dies_per_channel=dies,
            pages_per_chip=max(wl.n_index_pages // (channels * dies) + 1, 8),
            device_seed=3, timeline=True, device="cpu"),
            RunConfig(burst=32, fused=True)))
    one, many = reps
    np.testing.assert_array_equal(one.read_values, many.read_values)
    assert many.sim_makespan_ns < one.sim_makespan_ns
    assert np.median(many.burst_latencies_ns) < \
        np.median(one.burst_latencies_ns)


# ---------------------------------------------------------- index wiring
def test_btree_on_sharded_backend_identical_to_jax():
    rng = np.random.default_rng(5)
    keys = (rng.choice(10**9, size=900, replace=False) + 1).astype(np.uint64)
    values = keys * np.uint64(13)
    bt = SimBTree(ShardedSsdBackend.from_geometry(
        channels=4, dies_per_channel=2, pages_per_chip=32, device="cpu"))
    jbt = JSimBTree(JSharded.from_geometry(
        channels=4, dies_per_channel=2, pages_per_chip=32))
    bt.bulk_load(keys, values)
    jbt.bulk_load(keys, values)
    for leaf in bt.leaves:                  # §V-A pairs on distinct chips
        assert decompose(leaf.key_page, 8)[0] != \
            decompose(leaf.value_page, 8)[0]
    probes = [int(k) for k in keys[::83]] + [int(keys[0]) + 1]
    want = [int(k) * 13 if k in set(keys.tolist()) else None for k in probes]
    assert bt.lookup_batch(probes) == jbt.lookup_batch(probes) == want
    lo, hi = int(np.percentile(keys, 40)), int(np.percentile(keys, 45))
    expect = sorted((int(k), int(k) * 13) for k in keys if lo <= int(k) < hi)
    assert sorted(bt.range_query(lo, hi)) == expect
    assert sorted(jbt.range_query(lo, hi)) == expect
    _same_stats(bt.backend, jbt.backend)


def test_secondary_index_on_sharded_backend():
    codec = RowCodec((Column("uid", 40), Column("age", 7),
                      Column("gender", 1)))
    rng = np.random.default_rng(8)
    rows = {"uid": rng.integers(0, 2**40, 1500, dtype=np.uint64),
            "age": rng.integers(0, 100, 1500, dtype=np.uint64),
            "gender": rng.integers(0, 2, 1500, dtype=np.uint64)}
    got = {}
    for name, make in (("scalar", lambda: make_backend(
            "scalar", SimChipArray(n_chips=8, pages_per_chip=8))),
            ("sharded", lambda: ShardedSsdBackend.from_geometry(
                channels=4, dies_per_channel=2, pages_per_chip=8,
                device="cpu"))):
        idx = SimSecondaryIndex(make(), codec)
        idx.load_rows(rows)
        got[name] = (np.sort(idx.select_equals("gender", 1)),
                     np.sort(idx.select_range("age", 30, 40)))
        if name == "sharded":
            assert idx.backend.stats.kernel_launches == 4
            assert idx.backend.stats.plans > 0
    np.testing.assert_array_equal(got["scalar"][0], got["sharded"][0])
    np.testing.assert_array_equal(got["scalar"][1], got["sharded"][1])
    want_age = np.sort(codec.encode_rows(rows)[
        (rows["age"] >= 30) & (rows["age"] < 40)])
    np.testing.assert_array_equal(got["sharded"][1], want_age)


def test_hash_index_on_sharded_backend_identical_to_jax():
    rng = np.random.default_rng(6)
    keys = (rng.choice(10**9, size=500, replace=False) + 1).astype(np.uint64)
    probes = [int(k) for k in keys[::19]] + [10**15 + 3]
    h = SimHashIndex(ShardedSsdBackend.from_geometry(
        channels=4, dies_per_channel=2, pages_per_chip=512, device="cpu"))
    jh = JSimHashIndex(jmake_backend("scalar", JSimChipArray(
        n_chips=8, pages_per_chip=512)))
    for k in keys:
        h.insert(int(k), int(k) * 7)
        jh.insert(int(k), int(k) * 7)
    got = h.lookup_batch(probes)
    assert got == jh.lookup_batch(probes)
    assert got[-1] is None and got[0] == int(keys[0]) * 7
