"""The port's host substrate against the JAX package's, exactly.

``PageCache``, ``DeadlineScheduler``, ``SSDSim`` and the analytic runner
are numpy copies in the port, so the same inputs must give the same
outputs, counters and floats — equality, not a tolerance: a difference
means the copy diverged.  ``runner.run`` runs over a small Fig-12-style
grid (baseline and SiM; cache coverage; read ratio; batching and full-page
knobs; one YCSB-E stream) and its ``RunReport`` must equal the JAX one
field for field.  ``repro_torch.database_index.main(device="cpu")`` must
return the numbers the JAX package's modules compute.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.cache.pagecache import PageCache as JPageCache
from repro.core.commands import Command as JCommand
from repro.core.engine import SimChipArray as JSimChipArray
from repro.core.scheduler import DeadlineScheduler as JDeadlineScheduler
from repro.flash import params as jparams
from repro.flash.ssd import SSDSim as JSSDSim
from repro.index.baseline import BaselineBTree as JBaselineBTree
from repro.index.btree import SimBTree as JSimBTree
from repro.index.hashindex import SimHashIndex as JSimHashIndex
from repro.workload.runner import run as jrun
from repro.workload.ycsb import generate as jgenerate
from repro_torch import database_index
from repro_torch.cache.pagecache import CacheStats, PageCache
from repro_torch.core import BatchStats, DeadlineScheduler
from repro_torch.core.commands import Command
from repro_torch.flash import params
from repro_torch.flash.params import DEFAULT_PARAMS
from repro_torch.flash.ssd import EnergyAccount, SSDSim
from repro_torch.frontend import LatencyReport, RunReport
from repro_torch.workload import runner
from repro_torch.workload.ycsb import generate


def _same_tree(a, b, path="report"):
    """Two dataclass trees equal field for field (floats by ==)."""
    assert type(a).__name__ == type(b).__name__, path
    if dataclasses.is_dataclass(a):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], path
        for f in dataclasses.fields(a):
            _same_tree(getattr(a, f.name), getattr(b, f.name),
                       f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# ------------------------------------------------------------- page cache

def _cache_trace(cache, seed, n=3000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        page = int(rng.integers(0, 96))
        if rng.random() < 0.4:
            out.append(("hit", cache.lookup(page)))
        else:
            out.append(("ev", cache.insert(page, dirty=bool(
                rng.random() < 0.5))))
        out.append(("state", len(cache), cache.dirty_count, page in cache))
    out.append(("flush", sorted(cache.flush_all())))
    return out


@pytest.mark.parametrize("capacity,dirty", [(0, 1.0), (1, 1.0), (32, 1.0),
                                            (32, 0.2), (200, 0.5)])
def test_page_cache_identical_to_jax(capacity, dirty):
    c, jc = PageCache(capacity, dirty), JPageCache(capacity, dirty)
    assert _cache_trace(c, capacity) == _cache_trace(jc, capacity)
    assert dataclasses.asdict(c.stats) == dataclasses.asdict(jc.stats)
    assert c.stats.hit_rate == jc.stats.hit_rate
    assert isinstance(c.stats, CacheStats)


def test_page_cache_lru_and_dirty_budget():
    c = PageCache(10, max_dirty_fraction=0.2)     # budget = 2 dirty pages
    assert c.insert(1, dirty=True) == []
    assert c.insert(2, dirty=True) == []
    assert c.insert(3, dirty=True) == [(1, True)]
    assert c.dirty_count == 2
    c = PageCache(2)
    c.insert(1, dirty=False)
    c.insert(2, dirty=False)
    c.lookup(1)
    assert c.insert(3, dirty=False) == [(2, False)]


# ------------------------------------------------------ deadline scheduler

def _schedule(sch, cmd_cls, seed):
    rng = np.random.default_rng(seed)
    out, now = [], 0
    for i in range(400):
        now += int(rng.integers(0, 900))
        sch.submit(cmd_cls.search(int(rng.integers(0, 12)), i), now_ns=now)
        out.append(("next", sch.next_expiry(), len(sch)))
        for batch in sch.pop_expired(now_ns=now):
            out.append(("batch", [(c.page_addr, c.query, c.deadline_ns)
                                  for c in batch]))
    out.append(("drain", [[c.page_addr for c in b] for b in sch.drain()]))
    return out


@pytest.mark.parametrize("deadline_ns", [0, 1000, 4000])
def test_deadline_scheduler_identical_to_jax(deadline_ns):
    sch, jsch = DeadlineScheduler(deadline_ns), JDeadlineScheduler(deadline_ns)
    assert _schedule(sch, Command, deadline_ns) == \
        _schedule(jsch, JCommand, deadline_ns)
    assert dataclasses.asdict(sch.stats) == dataclasses.asdict(jsch.stats)
    assert sch.stats.mean_batch == jsch.stats.mean_batch
    assert isinstance(sch.stats, BatchStats) and len(sch) == 0


# ---------------------------------------------------------------- SSD sim

def test_flash_params_identical_to_jax():
    assert dataclasses.asdict(DEFAULT_PARAMS) == \
        dataclasses.asdict(jparams.DEFAULT_PARAMS)
    for name in ("US", "MS", "BITMAP_BYTES", "CHUNK_BYTES",
                 "OPEN_OVERHEAD_BYTES", "PAGE_BYTES"):
        assert getattr(params, name) == getattr(jparams, name)
    p, jp = DEFAULT_PARAMS, jparams.DEFAULT_PARAMS
    for prop in ("n_dies", "pages_per_die", "total_pages", "capacity_bytes",
                 "match_bus_bytes_per_ns", "storage_bus_bytes_per_ns",
                 "pcie_bytes_per_ns", "t_match_ns"):
        assert getattr(p, prop) == getattr(jp, prop)
    for fn in ("e_sense_pj", "e_program_pj", "e_match_pj"):
        assert getattr(p, fn)() == getattr(jp, fn)()
    assert p.e_bus_pj(4096, False) == jp.e_bus_pj(4096, False)
    assert p.bus_time_ns(64, True) == jp.bus_time_ns(64, True)


def _mini(mod):
    return mod.FlashParams(channels=2, dies_per_channel=2, blocks_per_plane=4,
                           pages_per_block=64)


def _drive_ssd(ssd, seed):
    rng = np.random.default_rng(seed)
    ends, now = [], 0.0
    for i in range(1500):
        kp, vp = int(rng.integers(0, 64)), int(rng.integers(64, 128))
        op = rng.random()
        if op < 0.5:
            ends.append(ssd.read(kp, vp, now, force_full_page=bool(
                rng.random() < 0.1), batch_extra=int(rng.integers(0, 3))))
        elif op < 0.8:
            ends.append(ssd.submit_write(kp, vp, now))
        else:
            ends.append(ssd.scan(list(range(kp, kp + int(
                rng.integers(1, 4)))), now))
        if i % 500 == 250:
            ssd.block_die(1, now + 5e4)
            ssd.block_channel(0, now + 2e4)
        now += float(rng.integers(0, 20_000))
    return ends


@pytest.mark.parametrize("system", ["baseline", "sim"])
@pytest.mark.parametrize("cache_pages", [0, 16])
@pytest.mark.parametrize("power_budget_ma", [None, 40.0])
def test_ssd_sim_identical_to_jax(system, cache_pages, power_budget_ma):
    kw = dict(n_index_pages=128, cache_pages=cache_pages, system=system,
              power_budget_ma=power_budget_ma, seed=3)
    ssd, jssd = SSDSim(_mini(params), **kw), JSSDSim(_mini(jparams), **kw)
    assert _drive_ssd(ssd, 1) == _drive_ssd(jssd, 1)
    assert dataclasses.asdict(ssd.stats) == dataclasses.asdict(jssd.stats)
    assert dataclasses.asdict(ssd.energy) == dataclasses.asdict(jssd.energy)
    assert ssd.energy.total_pj == jssd.energy.total_pj > 0
    assert isinstance(ssd.energy, EnergyAccount)
    for f in ("read_latencies", "write_latencies", "scan_latencies"):
        assert getattr(ssd, f) == getattr(jssd, f)
    for f in ("die_sense_free", "die_prog_free", "chan_free", "open_page"):
        np.testing.assert_array_equal(getattr(ssd, f), getattr(jssd, f))
    assert dataclasses.asdict(ssd.cache.stats) == \
        dataclasses.asdict(jssd.cache.stats)


# ------------------------------------------------------------- the runner

GRID = [(system, rr, cov) for system in ("baseline", "sim")
        for rr in (1.0, 0.4) for cov in (0.0, 0.25)]


@pytest.mark.parametrize("system,read_ratio,coverage", GRID)
def test_runner_report_identical_to_jax(system, read_ratio, coverage):
    gen = dict(n_key_pages=256, read_ratio=read_ratio, alpha=0.9, seed=1)
    wl, jwl = generate(1500, **gen), jgenerate(1500, **gen)
    kw = dict(system=system, cache_coverage=coverage)
    got = runner.run(wl, params=DEFAULT_PARAMS, **kw)
    want = jrun(jwl, params=jparams.DEFAULT_PARAMS, **kw)
    _same_tree(got, want)
    assert got.source == "analytic" and got.qps > 0


@pytest.mark.parametrize("knobs", [dict(batch_deadline_ns=2e4),
                                   dict(full_page_read_ratio=0.3),
                                   dict(power_budget_ma=50.0, clients=4)])
def test_runner_knobs_identical_to_jax(knobs):
    gen = dict(n_key_pages=128, read_ratio=0.7, alpha=0.9, seed=4)
    wl, jwl = generate(1200, **gen), jgenerate(1200, **gen)
    got = runner.run(wl, params=DEFAULT_PARAMS, system="sim",
                     cache_coverage=0.1, **knobs)
    want = jrun(jwl, params=jparams.DEFAULT_PARAMS, system="sim",
                cache_coverage=0.1, **knobs)
    _same_tree(got, want)


@pytest.mark.parametrize("system", ["baseline", "sim"])
def test_runner_ycsb_e_identical_to_jax(system):
    gen = dict(n_key_pages=128, read_ratio=0.0, alpha=0.9, seed=2,
               scan_ratio=0.95, max_scan_len=100)
    wl, jwl = generate(1000, **gen), jgenerate(1000, **gen)
    got = runner.run(wl, params=DEFAULT_PARAMS, system=system,
                     cache_coverage=0.1)
    want = jrun(jwl, params=jparams.DEFAULT_PARAMS, system=system,
                cache_coverage=0.1)
    _same_tree(got, want)
    assert got.scans > 0


def test_runner_aliases_and_report_builders():
    assert runner.RunResult is runner.FunctionalRunResult is RunReport
    assert runner.WARMUP_FRACTION == 0.30
    from repro.frontend.report import LatencyReport as JLatencyReport
    lats = np.random.default_rng(0).exponential(1e4, 257)
    _same_tree(LatencyReport.from_read_latencies(lats, makespan_ns=3e6,
                                                 n_ops=257),
               JLatencyReport.from_read_latencies(lats, makespan_ns=3e6,
                                                  n_ops=257))
    _same_tree(LatencyReport.from_read_latencies([]),
               JLatencyReport.from_read_latencies([]))
    r = RunReport.from_analytic(
        qps=1.5, read_median_ns=2.0, read_p25_ns=1.0, read_p75_ns=3.0,
        read_p99_ns=9.0, energy_pj=4.0, programs=5, senses=6,
        internal_bytes=7, pcie_bytes=8, cache_hit_rate=0.5,
        absorbed_writes=9, batched_searches=10, makespan_ns=11.0,
        writes=12, scans=13, reads=14)
    assert (r.qps, r.read_median_ns, r.read_p99_ns, r.energy_pj,
            r.sim_energy_pj, r.programs, r.senses, r.internal_bytes,
            r.pcie_bytes, r.cache_hit_rate, r.absorbed_writes,
            r.batched_searches, r.makespan_ns, r.sim_makespan_ns, r.writes,
            r.n_writes, r.scans, r.n_reads) == \
        (1.5, 2.0, 9.0, 4.0, 4.0, 5, 6, 7, 8, 0.5, 9, 10, 11.0, 11.0, 12,
         12, 13, 14)


# ------------------------------------------------- the slice's entry point

def test_database_index_main_on_cpu_equals_jax_modules():
    got = database_index.main(device="cpu")
    rng = np.random.default_rng(0)
    keys = (rng.choice(10**9, size=5000, replace=False) + 1).astype(np.uint64)
    values = keys * np.uint64(17)
    bt = JSimBTree(JSimChipArray(n_chips=8, pages_per_chip=64))
    bt.bulk_load(keys, values)
    bb = JBaselineBTree(JSimChipArray(n_chips=8, pages_per_chip=64))
    bb.bulk_load(keys, values)
    probes = [int(k) for k in rng.choice(keys, size=200, replace=False)]
    assert bt.lookup_batch(probes) == [bb.lookup(k) for k in probes]
    io = (bt.stats.bitmap_bytes + bt.stats.chunk_bytes, bt.stats.searches,
          bt.stats.gathers, bb.bytes_read, bb.pages_read)
    lo, hi = int(np.percentile(keys, 50)), int(np.percentile(keys, 52))
    rows = sorted(bt.range_query(lo, hi))
    h = JSimHashIndex(JSimChipArray(n_chips=8, pages_per_chip=512))
    for k in keys[:3000]:
        h.insert(int(k), int(k) % 99991)
    probe = [int(k) for k in keys[:3000:17]]
    want = {"lookups_agreed": 200, "sim_io_bytes": io[0],
            "searches": io[1], "gathers": io[2], "baseline_io_bytes": io[3],
            "baseline_pages": io[4], "range": (lo, hi),
            "range_rows": rows,
            "hash_ok": h.lookup_batch(probe) == [k % 99991 for k in probe],
            "splits": h.splits,
            "split_gathered_chunks": h.split_gathered_chunks,
            "global_depth": h.global_depth}
    assert got == want
    assert got["hash_ok"] and got["splits"] > 0 and got["range_rows"]
