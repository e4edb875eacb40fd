"""The port's device-fault tier and the event frontend's robustness tier
against the JAX package's, exactly.

Both packages run on the CPU: the port's sharded backend with
``device="cpu"`` (the plain PyTorch versions of its kernels), the JAX
package's with ``use_kernel=False``, as its own frontend tests run it.
Contracts, each with tolerance 0 (the fault draws, the event loop and the
flash timeline are host numpy on both sides):

  * ``FaultSchedule``'s four scenarios, ``DeviceFaultState``'s seeded
    program-failure draws, outage sets and stall windows equal JAX's;
  * **timeline stalls** — a ``BurstTimeline`` with a fault state attached
    gives burst and write latencies and energy equal by ``==``;
  * **replica parity anchor** — ``replicas=2`` with an empty fault
    schedule replays bit-identically to the fault-free serial replay;
  * **dead-chip failover** — chip 0 dead from t = 0 gives the healthy
    replay's values, with failovers > 0; without replicas its reads fail
    typed; in both, every counter and per-op error equals JAX's, save the
    launches, staged bytes and result bytes of the failover bursts, which
    the port serves through the kernels from replica rows where JAX reads
    the replica on the host: those three exceed JAX's by exactly what the
    failover bursts launched, staged and returned;
  * **chaos determinism** — each schedule shape replays twice to the same
    report, equal to JAX's (values, errors, counters, trace, tail);
  * **the chaos sweep** — ``benchmarks/chaos_sweep.py``'s own
    configuration: every counter and ``read_p99_us`` equals the committed
    ``BENCH_chaos_sweep.baseline.json`` (read as data), zero wrong results;
  * **the sharded reliability path** — ``vote_k`` senses a match and the
    open burst's retries and fallbacks on the timeline equal JAX's.
"""
import dataclasses
import json
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import ShardedSsdBackend as JSharded
from repro.core.commands import Command as JCommand
from repro.core.engine import SimChipArray as JSimChipArray
from repro.flash.timeline import BurstTimeline as JBurstTimeline
from repro.flash.timeline import ChipBurst as JChipBurst
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.reliability import DeviceFaultState as JDeviceFaultState
from repro.reliability import FaultModel as JFaultModel
from repro.reliability import FaultSchedule as JFaultSchedule
from repro.reliability import ReliabilityPolicy as JReliabilityPolicy
from repro.reliability import ReliabilityState as JReliabilityState
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import ShardedSsdBackend
from repro_torch.core.commands import Command
from repro_torch.core.ecc import OpenVerdict
from repro_torch.core.engine import SimChipArray
from repro_torch.flash.timeline import BurstTimeline, ChipBurst
from repro_torch.frontend import RunConfig, replay
from repro_torch.reliability import (DegradedReadError, DeviceFaultState,
                                     FaultModel, FaultSchedule,
                                     ReliabilityPolicy, ReliabilityState,
                                     StallWindow)
from repro_torch.workload.ycsb import generate

BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "BENCH_chaos_sweep.baseline.json"
COUNTERS = ("timeouts", "retries", "backoff_waits", "hedges_won",
            "failovers", "remapped_blocks", "degraded_ops", "shed_requests",
            "replica_programs", "program_failures")


def _schedules(cls, seed):
    return {
        "healthy": cls.healthy(seed=seed),
        "transient_stall": cls.transient_stall(die=0, t_start_ms=0.05,
                                               dur_ms=1.0, seed=seed),
        "dying_die": cls.dying_die(die=1, t_fail_ms=0.5,
                                   program_fail_prob=0.05, seed=seed),
        "dead_chip": cls.dead_chip(chip=0, seed=seed),
    }


class _Failovers(ShardedSsdBackend):
    """The port's sharded backend, recording what its failover bursts add
    to the device-traffic counters."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.failover_launches = self.failover_cmds = 0
        self.failover_result_bytes = 0

    def _flush_failover(self, failover):
        before = self.stats.kernel_launches
        super()._flush_failover(failover)
        self.failover_launches += self.stats.kernel_launches - before
        self.failover_cmds += sum(map(len, failover.values()))
        tickets = [t for items in failover.values() for _, t, _ in items]
        before = self.stats.result_bytes
        for t in tickets:              # drains the failover tails now
            t.result()
        self.failover_result_bytes += self.stats.result_bytes - before


def _replicated(n_index_pages, replicas=2, *, jax_=False, **kw):
    """Sharded backend of 4 chips with spare headroom for the replica
    copies plus grown-bad-block remaps."""
    per_chip = (n_index_pages // 4 + 1) * (replicas + 1)
    if jax_:
        return JSharded(JSimChipArray(n_chips=4, pages_per_chip=per_chip,
                                      device_seed=3),
                        use_kernel=False, interpret=True,
                        replicas=replicas, **kw)
    return _Failovers(SimChipArray(n_chips=4, pages_per_chip=per_chip,
                                   device_seed=3),
                      replicas=replicas, device="cpu", **kw)


def _both(wl_kw, cfg, replicas=2, **kw):
    """One replay in each package: (port report, JAX report).  ``cfg`` maps
    (RunConfig class, FaultSchedule class) to a config."""
    wl, jwl = generate(**wl_kw), jgenerate(**wl_kw)
    be = _replicated(wl.n_index_pages, replicas, **kw)
    port = replay(wl, be, cfg(RunConfig, FaultSchedule))
    port.failover_backend = be
    ref = jreplay(jwl, _replicated(jwl.n_index_pages, replicas, jax_=True,
                                   **kw), cfg(JRunConfig, JFaultSchedule))
    return port, ref


def _same(port, ref):
    for f in ("read_values", "read_hits", "scan_counts"):
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    # Failovers run on the card in the port and on the host in JAX.
    be = port.failover_backend
    assert be.failover_cmds == port.faults.degraded_ops
    assert (be.failover_launches > 0) == (be.failover_cmds > 0)
    extra = dict(kernel_launches=be.failover_launches,
                 staged_bytes=(0 if be._failover_store is None
                               else be._failover_store.staged_bytes),
                 result_bytes=be.failover_result_bytes)
    want = dataclasses.asdict(ref.counters)
    for f, n in extra.items():
        want[f] += n
    assert dataclasses.asdict(port.counters) == want
    for f in ("read_latencies_ns", "burst_latencies_ns",
              "write_latencies_ns"):
        np.testing.assert_array_equal(getattr(port.latency, f),
                                      getattr(ref.latency, f), err_msg=f)
    assert port.latency.read_p99_ns == ref.latency.read_p99_ns
    assert port.energy.total_pj == ref.energy.total_pj
    pf, rf = port.faults, ref.faults
    for c in COUNTERS + ("n_op_errors",):
        assert getattr(pf, c) == getattr(rf, c), c
    assert (pf.op_errors is None) == (rf.op_errors is None)
    if pf.op_errors is not None:
        np.testing.assert_array_equal(pf.op_errors, rf.op_errors)
    assert port.trace == ref.trace


# ------------------------------------------------- schedules and state
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_schedules_and_draws_equal_jax(seed):
    port, ref = _schedules(FaultSchedule, seed), _schedules(JFaultSchedule,
                                                            seed)
    for name in port:
        assert dataclasses.asdict(port[name]) \
            == dataclasses.asdict(ref[name]), name
        ps, rs = DeviceFaultState(port[name]), JDeviceFaultState(ref[name])
        for t in (0.0, 1e5, 2.5e5, 4e5, 5e5, 1e6, 2e6):
            assert ps.dead_chips(t) == rs.dead_chips(t)
            assert [dataclasses.asdict(w) for w in ps.stalls_active_at(t)] \
                == [dataclasses.asdict(w) for w in rs.stalls_active_at(t)]
        for page in range(40):
            for attempt in range(3):
                assert ps.program_fails(page, attempt) \
                    == rs.program_fails(page, attempt)
        assert dataclasses.asdict(ps.stats) == dataclasses.asdict(rs.stats)
    with pytest.raises(ValueError):
        StallWindow("plane", 0, 0.0, 1.0)
    with pytest.raises(ValueError):
        StallWindow("die", 0, 2.0, 1.0)
    with pytest.raises(ValueError):
        FaultSchedule(program_fail_prob=1.0)


def test_fault_clock_is_monotone():
    st = DeviceFaultState(FaultSchedule.dying_die(die=1, t_fail_ms=0.5))
    st.advance(6e5)
    st.advance(1e5)
    assert st.now_ns == 6e5 and st.chip_dead(1) and not st.chip_dead(0)
    st.mark_bad(7, 99)
    assert st.remap == {7: 99} and st.stats.remapped_blocks == 1


@pytest.mark.parametrize("kind", ["transient_stall", "dying_die"])
def test_timeline_stalls_equal_jax(kind):
    sched = {"transient_stall": dict(die=0, t_start_ms=0.05, dur_ms=1.0),
             "dying_die": dict(die=1, t_fail_ms=0.5)}[kind]
    out = []
    for tl_cls, burst_cls, sched_cls, state_cls in (
            (BurstTimeline, ChipBurst, FaultSchedule, DeviceFaultState),
            (JBurstTimeline, JChipBurst, JFaultSchedule,
             JDeviceFaultState)):
        tl = tl_cls.for_chips(4)
        tl.attach_faults(state_cls(getattr(sched_cls, kind)(seed=5,
                                                            **sched)))
        for i in range(12):
            at = i * 7.5e4
            tl.observe_flush([burst_cls(c, senses=2, matches=3,
                                        bus_match_bytes=640,
                                        pcie_bytes=1024)
                              for c in range(4)], at=at)
            tl.observe_program(i % 4, at=at + 1e3)
        out.append((tl.burst_latencies, tl.write_latencies, tl.now,
                    tl.energy_pj))
    assert out[0] == out[1]
    stalled = out[0][0]
    healthy = BurstTimeline.for_chips(4)
    for i in range(12):
        healthy.observe_flush([ChipBurst(c, senses=2, matches=3,
                                         bus_match_bytes=640,
                                         pcie_bytes=1024)
                               for c in range(4)], at=i * 7.5e4)
        healthy.observe_program(i % 4, at=i * 7.5e4 + 1e3)
    assert max(stalled) > max(healthy.burst_latencies)


# ------------------------------------------------------------ replays
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("buffered", [False, True])
def test_replica_event_serial_bit_parity(fused, buffered):
    """replicas=2 plus an attached empty schedule changes no bit of the
    replay; the event report equals JAX's."""
    wl_kw = dict(n_queries=300, n_key_pages=8, read_ratio=0.5, alpha=0.9,
                 seed=7, scan_ratio=0.05)
    kw = dict(burst=32, fused=fused)
    if buffered:
        kw.update(write_buffer=True, write_high_water=4)
    wl = generate(**wl_kw)
    serial = replay(wl, _replicated(wl.n_index_pages), RunConfig(**kw))
    port, ref = _both(wl_kw, lambda c, f: c.event_serial(
        faults=f.healthy(seed=7), **kw))
    _same(port, ref)
    for f in ("read_values", "read_hits", "scan_counts"):
        np.testing.assert_array_equal(getattr(serial, f), getattr(port, f))
    f = port.faults
    assert f.replica_programs > 0
    assert (f.timeouts, f.retries, f.failovers, f.degraded_ops,
            f.remapped_blocks, f.shed_requests, f.n_op_errors) \
        == (0, 0, 0, 0, 0, 0, 0)


def test_dead_chip_failover_bit_identical_to_healthy():
    wl_kw = dict(n_queries=300, n_key_pages=8, read_ratio=0.6, alpha=0.9,
                 seed=7, scan_ratio=0.05)
    kw = dict(burst=16, fused=True, seed=7)
    healthy, _ = _both(wl_kw, lambda c, f: c.event_serial(
        faults=f.healthy(seed=7), **kw))
    dead, ref = _both(wl_kw, lambda c, f: c.event_serial(
        faults=f.dead_chip(chip=0, seed=7), **kw))
    _same(dead, ref)
    for f in ("read_values", "read_hits", "scan_counts"):
        np.testing.assert_array_equal(getattr(healthy, f), getattr(dead, f))
    assert dead.faults.failovers > 0 and dead.faults.degraded_ops > 0
    assert dead.faults.n_op_errors == 0


@pytest.mark.parametrize("fused", [False, True])
def test_dead_chip_serial_replay_equals_jax(fused):
    """Faults in serial mode act on the backend's flush path alone: the
    dead chip's reads fail over at flush, its writes relocate."""
    wl_kw = dict(n_queries=240, n_key_pages=8, read_ratio=0.7, alpha=0.9,
                 seed=5, scan_ratio=0.05)
    port, ref = _both(wl_kw, lambda c, f: c(
        burst=16, fused=fused, faults=f.dead_chip(chip=2, seed=1)),
        timeline=True)
    _same(port, ref)
    assert port.faults.failovers > 0 and port.faults.remapped_blocks > 0


def _same_fields(a, b):
    """Two responses (port, JAX) equal field by field."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_fields(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_failover_burst_through_the_kernels_equals_jax():
    """Chip 0 dead, replicas 2, the reliability tier attached and the
    replica of page 0 damaged in its header: one flush of searches, plans,
    lookups and gathers.  The failovers launch the kernels over the
    replica rows (one launch a phase beside the healthy phases'), bypass
    the tier and carry the replica's latch verdict (the open repairs the
    header) as JAX's host reads do; every response, the tier's and the
    fault state's stats and the timeline equal JAX's."""
    rng = np.random.default_rng(6)
    keys = [rng.integers(1, 2**62, 300, dtype=np.uint64) for _ in range(8)]
    port = _replicated(8, timeline=True)
    ref = _replicated(8, jax_=True, timeline=True)
    rep = []
    for be, cmd, dfs, fs, rs in (
            (port, Command, DeviceFaultState, FaultSchedule,
             ReliabilityState),
            (ref, JCommand, JDeviceFaultState, JFaultSchedule,
             JReliabilityState)):
        for p, k in enumerate(keys):
            be.program_entries(p, k)
        replica = be._replica_of[0][0]
        chip, local = be.chips.route(replica)
        chip.inject_bit_errors(local, 12, rng=np.random.default_rng(4),
                               byte_region=(0, 64))
        be.enable_reliability(rs())
        be.enable_device_faults(dfs(fs.dead_chip(chip=0)))
        lo = int(np.sort(keys[4])[10])
        cmds = [cmd.search(p, int(keys[p][7])) for p in range(8)]
        cmds += [cmd.lookup(p, p + 4, int(keys[p][-3])) for p in range(4)]
        cmds += [cmd.plan(p, [(lo, 0xFFFFFFFFFFFF0000)], [(lo, 2**64 - 1)])
                 for p in (0, 5)]
        cmds += [cmd.gather(p, 0b1011) for p in range(8)]
        tickets = [getattr(be, f"submit_{c.op.value}")(c) for c in cmds]
        be.flush()
        rep.append([t.result() for t in tickets])
    for a, b in zip(*rep):
        _same_fields(a, b)
    verdicts = [r.open_verdict if hasattr(r, "open_verdict") else
                r.search.open_verdict for r in rep[0]
                if not hasattr(r, "chunks")]
    assert OpenVerdict.FALLBACK_ECC.value in verdicts
    assert port.stats.kernel_launches == 8          # 4 healthy + 4 failover
    assert ref.stats.kernel_launches == 4
    assert dataclasses.asdict(port.faults.stats) \
        == dataclasses.asdict(ref.faults.stats)
    assert port.faults.stats.degraded_ops == 2 + 1 + 1 + 2
    assert dataclasses.asdict(port.reliability.stats) \
        == dataclasses.asdict(ref.reliability.stats)
    assert port.timeline.burst_latencies == ref.timeline.burst_latencies
    assert port.timeline.energy_pj == ref.timeline.energy_pj


def test_dead_chip_without_replicas_fails_typed():
    wl_kw = dict(n_queries=300, n_key_pages=8, read_ratio=0.6, alpha=0.9,
                 seed=7)
    r, ref = _both(wl_kw, lambda c, f: c.event_serial(
        faults=f.dead_chip(chip=0, seed=7), burst=16), replicas=1)
    _same(r, ref)
    f = r.faults
    assert f.n_op_errors > 0 and f.failovers == 0
    wl = generate(**wl_kw)
    healthy = replay(wl, _replicated(wl.n_index_pages, 1),
                     RunConfig.event_serial(burst=16))
    ok = ~f.op_errors
    np.testing.assert_array_equal(r.read_values[ok], healthy.read_values[ok])
    assert not r.read_hits[f.op_errors].any()
    assert not r.read_values[f.op_errors].any()


def test_degraded_read_error_is_typed_on_the_backend():
    be = _replicated(8, replicas=1)
    be.program_entries(4, np.arange(10, 20, dtype=np.uint64))
    st = DeviceFaultState(FaultSchedule.dead_chip(chip=0))
    be.enable_device_faults(st)
    with pytest.raises(DegradedReadError):
        be.search(Command.search(4, 12))
    assert be.stats.kernel_launches == 0


@pytest.mark.parametrize("kind", ["healthy", "transient_stall", "dying_die",
                                  "dead_chip"])
def test_chaos_determinism_equals_jax(kind):
    wl_kw = dict(n_queries=160, n_key_pages=8, read_ratio=0.6, alpha=0.9,
                 seed=4)

    def cfg(c, f):
        return c.chaos(_schedules(f, 3)[kind], deadline_ns=400_000.0,
                       max_retries=3, backoff_base_ns=100_000.0,
                       concurrency=4, burst=16, seed=5, record_trace=True)
    a, ref = _both(wl_kw, cfg)
    b, _ = _both(wl_kw, cfg)
    _same(a, ref)
    _same(b, ref)
    assert len(a.trace) > 0


def test_hedged_and_shed_runs_equal_jax():
    wl_kw = dict(n_queries=300, n_key_pages=8, read_ratio=0.8, alpha=0.9,
                 seed=2)
    for cfg in (
            lambda c, f: c.chaos(f.transient_stall(die=1, t_start_ms=0.05,
                                                   dur_ms=0.5, seed=2),
                                 hedge_quantile=0.5, concurrency=4,
                                 burst=8, seed=3, record_trace=True),
            lambda c, f: c(mode="event", fused=True, arrival="poisson",
                           arrival_rate_qps=5e5, concurrency=8,
                           scheduler="read_priority", ncq_depth=16,
                           shed_capacity=8, seed=3)):
        port, ref = _both(wl_kw, cfg)
        _same(port, ref)
    assert port.faults.shed_requests > 0


# ----------------------------------------------------- the chaos sweep
def test_chaos_sweep_counters_equal_baseline():
    """``benchmarks/chaos_sweep.py``'s configuration on the port: 16 key
    pages, 4 chips, replicas 2, 600 ops at read 0.8, seed 11, deadline
    500 us, 5 retries, backoff 100 us; the four schedules, then the
    overload shed run."""
    base = {m["name"]: m["value"]
            for m in json.loads(BASELINE.read_text())["metrics"]}
    got = {}
    wl = generate(600, n_key_pages=16, read_ratio=0.8, alpha=0.9, seed=7)
    exp = np.zeros(len(wl.ops), dtype=np.uint64)
    last: dict[int, int] = {}
    for qi in range(len(wl.ops)):
        k = int(wl.keys[qi])
        if wl.ops[qi] == 1:
            last[k] = qi
        elif wl.ops[qi] == 0:
            exp[qi] = np.uint64(last[k] * 2 + 1) if k in last else \
                np.uint64((((k + 1) * 0x9E3779B97F4A7C15) % 2**64) | 1)
    wrong = 0
    for name, sched in _schedules(FaultSchedule, 11).items():
        rep = replay(wl, _replicated(32), RunConfig.event_serial(
            fused=True, faults=sched, deadline_ns=500_000.0, max_retries=5,
            backoff_base_ns=100_000.0, seed=11))
        f = rep.faults
        ok = (wl.ops == 0) & ~f.op_errors
        wrong += int(np.sum(rep.read_values[ok] != exp[ok]))
        for c in COUNTERS:
            got[f"chaos_{name}_{c}"] = getattr(f, c)
        got[f"chaos_{name}_op_errors"] = f.n_op_errors
        got[f"chaos_{name}_read_p99_us"] = round(
            rep.latency.read_p99_ns / 1e3, 2)
        if name == "transient_stall":
            got["chaos_availability"] = 1.0 - f.n_op_errors / len(wl.ops)
    got["chaos_wrong_results"] = wrong
    wl = generate(600, n_key_pages=16, read_ratio=1.0, alpha=0.9, seed=7)
    rep = replay(wl, _replicated(32), RunConfig(
        mode="event", fused=True, arrival="poisson", arrival_rate_qps=5e5,
        concurrency=8, scheduler="read_priority", ncq_depth=16,
        shed_capacity=8, seed=11, faults=FaultSchedule.healthy(seed=11)))
    got["chaos_overload_shed_requests"] = rep.faults.shed_requests
    got["chaos_overload_completed_ok"] = int(np.sum(~rep.faults.op_errors))
    assert got == base


# ------------------------------------- the sharded reliability path
@pytest.mark.parametrize("sense_ber", [0.0, 2e-4])
def test_sharded_reliability_timeline_equals_jax(sense_ber):
    """The open burst's retries and fallback reads and ``vote_k`` senses
    a match reach the flash timeline as in JAX (vote factor 3 with sense
    noise, 1 without); split, fused and scan replays."""
    for wl_kw, cfg in (
            (dict(n_queries=120, n_key_pages=8, read_ratio=1.0, alpha=0.9,
                  seed=7), dict(burst=16, fused=False)),
            (dict(n_queries=120, n_key_pages=8, read_ratio=0.8, alpha=0.9,
                  seed=7, scan_ratio=0.1), dict(burst=16, fused=True))):
        out = []
        for fm, pol, st, c in (
                (FaultModel, ReliabilityPolicy, ReliabilityState,
                 RunConfig),
                (JFaultModel, JReliabilityPolicy, JReliabilityState,
                 JRunConfig)):
            rel = st(pol(vote_k=3), fm(seed=11, base_ber=1e-4,
                                       retention_days=90.0,
                                       sense_ber=sense_ber))
            out.append((rel, c.reliable(rel, **cfg)))
        wl, jwl = generate(**wl_kw), jgenerate(**wl_kw)
        port = replay(wl, _replicated(wl.n_index_pages, 1, timeline=True),
                      out[0][1])
        ref = jreplay(jwl, _replicated(jwl.n_index_pages, 1, jax_=True,
                                       timeline=True), out[1][1])
        assert out[0][0].vote_factor == (3 if sense_ber else 1)
        assert dataclasses.asdict(out[0][0].stats) \
            == dataclasses.asdict(out[1][0].stats)
        for f in ("read_values", "read_hits", "read_errors"):
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        for f in ("burst_latencies_ns", "write_latencies_ns"):
            np.testing.assert_array_equal(getattr(port.latency, f),
                                          getattr(ref.latency, f))
        assert port.energy.total_pj == ref.energy.total_pj
        assert port.latency.makespan_ns == ref.latency.makespan_ns


def test_remapped_program_reads_through_the_kernel_path():
    """A seeded program failure remaps a page to a spare; the read of the
    logical page follows the remap through the launch, equal to JAX."""
    sched = dict(program_fail_prob=0.5, seed=1)
    # Headroom: spares come off the top, far from the logical pages.
    port = _replicated(64, replicas=1, timeline=True)
    ref = _replicated(64, replicas=1, jax_=True, timeline=True)
    port.enable_device_faults(DeviceFaultState(FaultSchedule(**sched)))
    ref.enable_device_faults(JDeviceFaultState(JFaultSchedule(**sched)))
    keys = np.arange(100, 180, dtype=np.uint64)
    for be in (port, ref):
        for p in range(6):
            be.program_entries(p, keys + 100 * p)
    assert port.faults.remap == ref.faults.remap and port.faults.remap
    for p in range(6):
        got = port.search(Command.search(p, int(keys[3] + 100 * p)))
        want = ref.search(JCommand.search(p, int(keys[3] + 100 * p)))
        np.testing.assert_array_equal(got.bitmap_words, want.bitmap_words)
        assert got.match_count == 1
    assert port.stats.kernel_launches == ref.stats.kernel_launches == 6
    assert dataclasses.asdict(port.faults.stats) \
        == dataclasses.asdict(ref.faults.stats)
    assert port.timeline.burst_latencies == ref.timeline.burst_latencies
    assert port.timeline.write_latencies == ref.timeline.write_latencies
