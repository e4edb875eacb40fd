"""The port's event-driven frontend against its serial replay and against
the JAX package's event loop.

Contracts held here, each exactly (tolerance 0: the event loop and the
flash timeline do the same float64 numpy arithmetic in the same order in
both packages):

  * ``RunConfig`` — the event knobs validate as in the JAX package, the
    presets build the same shapes, and each robustness knob constructs
    and replays equal to the JAX package's event loop;
  * **bit-parity anchor** — ``RunConfig.event_serial()`` (one stream, zero
    inter-arrival, FIFO) replays bit-identically to ``mode="serial"`` on
    the scalar, batched and sharded backends, split and fused, eager and
    buffered: same values, hits, scan counts, programs, flushes and
    launches;
  * **determinism** — same seeds give the same trace and report, equal to
    the JAX package's;
  * **NCQ bound** — queued + inflight never exceeds ``ncq_depth``;
  * **scheduling** — FIFO reads queue behind a die-program backlog,
    read-priority reads program-suspend past it;
  * **latency sweep** — points of the JAX package's
    ``benchmarks/latency_sweep.py`` (scalar backend, ``open_loop``) at a
    reduced op count give the JAX package's per-request latencies;
  * **backend independence** — the same event config gives the same
    latency arrays on the scalar, batched and sharded backends.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import make_backend as jmake_backend
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.workload.ycsb import Workload as JWorkload
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import ShardedSsdBackend, make_backend
from repro_torch.core.engine import SimChipArray
from repro_torch.frontend import EventLoop, RunConfig, replay
from repro_torch.workload.ycsb import (KEYS_PER_PAGE, Workload, generate,
                                       value_page_of)

LATENCY_FIELDS = ("read_p50_ns", "read_p25_ns", "read_p75_ns", "read_p99_ns",
                  "qps", "makespan_ns", "read_latencies_ns",
                  "burst_latencies_ns", "write_latencies_ns")
EVENT_COUNTERS = ("reads", "writes", "scans", "flushes", "kernel_launches",
                  "staged_bytes", "result_bytes", "programs",
                  "write_flushes", "buffer_read_hits", "events",
                  "dispatches", "admitted", "admission_waits", "ncq_peak")


def _mk(name="scalar", n_chips=4, pages=32, **kw):
    if name != "scalar":
        kw.setdefault("device", "cpu")
    return make_backend(name, SimChipArray(
        n_chips=n_chips, pages_per_chip=pages, device_seed=3), **kw)


def _jmk(n_chips=4, pages=32):
    return jmake_backend("scalar", JSimChipArray(
        n_chips=n_chips, pages_per_chip=pages, device_seed=3))


def _jconfig(config: RunConfig) -> JRunConfig:
    return JRunConfig(**vars(config))


def _same_event_report(got, want):
    np.testing.assert_array_equal(got.read_values, want.read_values)
    np.testing.assert_array_equal(got.read_hits, want.read_hits)
    for f in LATENCY_FIELDS:
        a, b = getattr(got.latency, f), getattr(want.latency, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert got.energy.total_pj == want.energy.total_pj
    for c in EVENT_COUNTERS:
        assert getattr(got.counters, c) == getattr(want.counters, c), c
    assert got.trace == want.trace


# --------------------------------------------------------------- RunConfig
def test_runconfig_event_knobs_validated_as_in_jax():
    for kw in (dict(concurrency=4), dict(scheduler="read_priority"),
               dict(arrival="poisson", arrival_rate_qps=1e5),
               dict(mode="event", arrival="poisson"),
               dict(mode="event", arrival="trace"),
               dict(mode="event", arrival_rate_qps=1e5),
               dict(mode="event", arrival="trace",
                    arrival_times_ns=[-1.0]),
               dict(mode="turbo"), dict(mode="event", ncq_depth=0)):
        with pytest.raises(ValueError):
            RunConfig(**kw)
        with pytest.raises(ValueError):
            JRunConfig(**kw)
    cfg = RunConfig(mode="event", arrival="trace",
                    arrival_times_ns=[0, 10, 20])
    assert cfg.arrival_times_ns == (0.0, 10.0, 20.0)


def test_runconfig_presets_match_jax():
    for name, args, kw in (("buffered", (), dict(write_high_water=4)),
                           ("open_loop", (2e5,), dict(concurrency=8)),
                           ("event_serial", (), dict(burst=8)),
                           ("eager", (), dict(fused=True))):
        got = getattr(RunConfig, name)(*args, **kw)
        assert vars(got) == vars(getattr(JRunConfig, name)(*args, **kw))
    e = RunConfig.event_serial(burst=8)
    assert (e.mode, e.concurrency, e.arrival, e.scheduler) \
        == ("event", 1, "zero", "fifo")


# The name is from before slice 7, when this path raised; it is kept so
# the test's ID stays stable across the port's slices.
@pytest.mark.parametrize("knob", [dict(reliability="noisy, vote_k 3"),
                                  dict(faults="transient stall"),
                                  dict(deadline_ns=1e6),
                                  dict(hedge_quantile=0.9),
                                  dict(shed_capacity=4)])
def test_event_robustness_knobs_still_raise(knob):
    """The robustness tier is ported: each knob constructs in event mode
    (the fields equal the JAX package's, and the ``reliable()`` and
    ``chaos()`` presets build the same shapes), refuses what JAX refuses,
    and an event replay with it equals the JAX package's event loop."""
    from repro.reliability import FaultModel as JFaultModel
    from repro.reliability import FaultSchedule as JFaultSchedule
    from repro.reliability import ReliabilityPolicy as JReliabilityPolicy
    from repro.reliability import ReliabilityState as JReliabilityState
    from repro_torch.reliability import (FaultModel, FaultSchedule,
                                         ReliabilityPolicy, ReliabilityState)

    (field, value), = knob.items()
    base = dict(mode="event", concurrency=4, scheduler="read_priority",
                burst=8, seed=5, record_trace=True)
    if field == "reliability":
        fault = dict(seed=11, base_ber=0.0, sense_ber=1e-3)
        kw = dict(base, reliability=ReliabilityState(
            ReliabilityPolicy(vote_k=3), FaultModel(**fault)))
        jkw = dict(base, reliability=JReliabilityState(
            JReliabilityPolicy(vote_k=3), JFaultModel(**fault)))
        for cfg, rel in ((RunConfig, kw[field]), (JRunConfig, jkw[field])):
            with pytest.raises(ValueError):
                cfg.reliable(None)
            assert cfg.reliable(rel, burst=8).reliability is rel
    elif field == "faults":
        sched = dict(die=1, t_start_ms=0.05, dur_ms=0.5, seed=2)
        kw = dict(vars(RunConfig.chaos(
            FaultSchedule.transient_stall(**sched), burst=8, seed=5,
            concurrency=4, record_trace=True)))
        jkw = dict(vars(JRunConfig.chaos(
            JFaultSchedule.transient_stall(**sched), burst=8, seed=5,
            concurrency=4, record_trace=True)))
        assert {k: v for k, v in kw.items() if k != "faults"} \
            == {k: v for k, v in jkw.items() if k != "faults"}
        assert dataclasses.asdict(kw["faults"]) \
            == dataclasses.asdict(jkw["faults"])
        for cfg in (RunConfig, JRunConfig):
            with pytest.raises(ValueError):
                cfg.chaos(None)
    else:
        kw = dict(base, **knob)
        jkw = dict(base, **knob)
        for bad in {"deadline_ns": (0, -1.0), "hedge_quantile": (0, 1.5),
                    "shed_capacity": (-1, 1.5)}[field]:
            for cfg in (RunConfig, JRunConfig):
                with pytest.raises(ValueError):
                    cfg(**dict(base, **{field: bad}))
        if field == "shed_capacity":
            kw.update(arrival="poisson", arrival_rate_qps=5e5, ncq_depth=8)
            jkw.update(arrival="poisson", arrival_rate_qps=5e5, ncq_depth=8)
    cfg = RunConfig(**kw)
    assert {k: v for k, v in vars(cfg).items()
            if k not in ("reliability", "faults")} \
        == {k: v for k, v in vars(JRunConfig(**jkw)).items()
            if k not in ("reliability", "faults")}
    wl = generate(200, n_key_pages=8, read_ratio=0.8, alpha=0.9, seed=4)
    jwl = jgenerate(200, n_key_pages=8, read_ratio=0.8, alpha=0.9, seed=4)
    got = replay(wl, _mk("scalar"), cfg)
    want = jreplay(jwl, _jmk(), JRunConfig(**jkw))
    _same_event_report(got, want)
    for f in ("timeouts", "retries", "backoff_waits", "hedges_won",
              "shed_requests", "n_op_errors"):
        assert getattr(got.faults, f) == getattr(want.faults, f), f
    if field == "reliability":
        np.testing.assert_array_equal(got.reliability.read_errors,
                                      want.reliability.read_errors)
        assert vars(got.reliability.stats) == vars(want.reliability.stats)
    if field == "shed_capacity":
        assert got.faults.shed_requests > 0


# ------------------------------------------------------ bit-parity anchor
def _assert_parity(rs, re):
    np.testing.assert_array_equal(rs.read_values, re.read_values)
    np.testing.assert_array_equal(rs.read_hits, re.read_hits)
    if rs.scan_counts is not None or re.scan_counts is not None:
        np.testing.assert_array_equal(rs.scan_counts, re.scan_counts)
    for c in ("programs", "flushes", "write_flushes", "buffer_read_hits",
              "kernel_launches", "staged_bytes", "result_bytes"):
        assert getattr(rs, c) == getattr(re, c), c


@pytest.fixture(scope="module")
def parity_workload():
    return generate(300, n_key_pages=8, read_ratio=0.5, alpha=0.9, seed=7,
                    scan_ratio=0.05)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("buffered", [False, True])
@pytest.mark.parametrize("name", ["scalar", "batched", "sharded"])
def test_event_serial_bit_parity(parity_workload, name, fused, buffered):
    wl = parity_workload
    kw = dict(burst=32, fused=fused)
    if buffered:
        kw.update(write_buffer=True, write_high_water=4)
    pages = max(wl.n_index_pages // 4 + 1, 8)

    def mk():
        if name == "sharded":
            return ShardedSsdBackend.from_geometry(
                channels=2, dies_per_channel=2, pages_per_chip=pages,
                device_seed=3, device="cpu")
        return _mk(name, n_chips=4, pages=pages)

    rs = replay(wl, mk(), RunConfig(**kw))
    re = replay(wl, mk(), RunConfig.event_serial(**kw))
    _assert_parity(rs, re)
    assert re.counters.dispatches > 0 and re.latency.read_p99_ns > 0
    assert rs.n_scans == re.n_scans > 0


def test_event_mode_reports_its_own_clock_not_the_backends(
        parity_workload):
    """Event mode owns its clock: a sharded backend with a timeline still
    records its flushes there, but the report's latencies are the event
    loop's — equal to the same event replay on the scalar backend."""
    wl = parity_workload
    be = ShardedSsdBackend.from_geometry(
        channels=2, dies_per_channel=2, pages_per_chip=8, device_seed=3,
        timeline=True, device="cpu")
    cfg = RunConfig.event_serial(burst=32, fused=True)
    rep = replay(wl, be, cfg)
    assert len(be.timeline.burst_latencies) == rep.flushes
    scalar = replay(wl, _mk("scalar", pages=8), cfg)
    for f in LATENCY_FIELDS:
        np.testing.assert_array_equal(getattr(rep.latency, f),
                                      getattr(scalar.latency, f))


# ------------------------------------------------------------ determinism
def test_event_loop_deterministic_trace_and_report_equal_to_jax():
    kw = dict(n_key_pages=8, read_ratio=0.5, alpha=0.9, seed=1)
    wl, jwl = generate(400, **kw), jgenerate(400, **kw)
    cfg = RunConfig.open_loop(3e5, concurrency=4, burst=32, seed=12,
                              write_buffer=True, write_high_water=4,
                              record_trace=True)
    a = replay(wl, _mk(pages=16), cfg)
    b = replay(wl, _mk(pages=16), cfg)
    assert a.trace == b.trace and len(a.trace) > 0
    np.testing.assert_array_equal(a.read_values, b.read_values)
    assert a.counters == b.counters
    _same_event_report(a, jreplay(jwl, _jmk(pages=16), _jconfig(cfg)))
    c = replay(wl, _mk(pages=16), cfg.with_(seed=13))
    assert c.trace != a.trace


def test_event_counters_account_for_every_op():
    wl = generate(300, n_key_pages=8, read_ratio=0.6, alpha=0.9, seed=2)
    r = replay(wl, _mk(pages=16),
               RunConfig.open_loop(3e5, concurrency=4, ncq_depth=16,
                                   burst=16))
    c = r.counters
    assert c.admitted + c.admission_waits == len(wl.ops)
    assert c.admission_waits > 0 and c.ncq_peak <= 16
    assert c.dispatches > 0 and c.events >= len(wl.ops)
    assert r.latency.qps > 0 and r.latency.makespan_ns > 0
    assert len(r.latency.read_latencies_ns) == c.reads


# ------------------------------------------------------------- NCQ bound
@pytest.mark.parametrize("seed", range(6))
def test_ncq_depth_bound_seeded_traces(seed):
    wl = generate(60, n_key_pages=4, read_ratio=0.5, alpha=0.9, seed=5)
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 2e6, 60)).tolist()
    depth = int(rng.integers(1, 9))
    sched = ["fifo", "read_priority", "fair_share"][seed % 3]
    loop = EventLoop(wl, _mk(pages=16), RunConfig(
        mode="event", arrival="trace", arrival_times_ns=times,
        concurrency=3, scheduler=sched, ncq_depth=depth, burst=8,
        write_buffer=True, write_high_water=4))
    r = loop.run()
    assert loop.ncq_peak <= depth
    assert r.counters.admitted + r.counters.admission_waits == 60
    assert r.counters.reads + r.counters.writes + r.counters.scans == 60


def test_ncq_depth_bound_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    wl = generate(60, n_key_pages=4, read_ratio=0.5, alpha=0.9, seed=5)

    @hypothesis.given(
        times=st.lists(st.floats(min_value=0.0, max_value=2e6,
                                 allow_nan=False), min_size=60, max_size=60),
        depth=st.integers(min_value=1, max_value=8),
        sched=st.sampled_from(["fifo", "read_priority", "fair_share"]))
    @hypothesis.settings(max_examples=15, deadline=None)
    def prop(times, depth, sched):
        loop = EventLoop(wl, _mk(pages=16), RunConfig(
            mode="event", arrival="trace", arrival_times_ns=times,
            concurrency=3, scheduler=sched, ncq_depth=depth, burst=8,
            write_buffer=True, write_high_water=4))
        r = loop.run()
        assert loop.ncq_peak <= depth
        assert r.counters.admitted + r.counters.admission_waits == 60

    prop()


# ------------------------------------------------------------- scheduling
def _backlog_workload(cls, n_key_pages=2):
    """Ten writes land a program backlog on every die, then ten reads
    arrive 1 us later, well inside the 80 us programs."""
    keys = np.asarray(list(range(10)) + [k + KEYS_PER_PAGE
                                         for k in range(10)], np.int64)
    ops = np.asarray([1] * 10 + [0] * 10, dtype=np.uint8)
    kp = (keys // KEYS_PER_PAGE).astype(np.int32)
    vp = value_page_of(kp, n_key_pages).astype(np.int32)
    wl = cls(ops=ops, key_pages=kp, value_pages=vp, alpha=0.0,
             read_ratio=0.5, n_index_pages=2 * n_key_pages, keys=keys)
    return wl, [0.0] * 10 + [1_000.0] * 10


@pytest.mark.parametrize("sched,expect_stalled", [
    ("fifo", True), ("read_priority", False), ("fair_share", False)])
def test_read_priority_bypasses_program_backlog(sched, expect_stalled):
    wl, times = _backlog_workload(Workload)
    jwl, _ = _backlog_workload(JWorkload)
    cfg = RunConfig(mode="event", arrival="trace", arrival_times_ns=times,
                    scheduler=sched, burst=16, ncq_depth=32)
    r = replay(wl, _mk(n_chips=2, pages=8), cfg)
    assert r.read_hits.sum() == 10 and r.programs == 10
    # t_program = 80 us: FIFO reads queue behind the die backlog.
    assert (r.latency.read_p50_ns > 50_000.0) == expect_stalled
    _same_event_report(r, jreplay(jwl, _jmk(n_chips=2, pages=8),
                                  _jconfig(cfg)))


def test_fifo_vs_read_priority_same_totals_worse_fifo_tail():
    wl = generate(400, n_key_pages=8, read_ratio=0.5, alpha=0.9, seed=3)
    reps = {s: replay(wl, _mk(pages=16), RunConfig(
        mode="event", arrival="zero", concurrency=2, scheduler=s, burst=32,
        write_buffer=True, write_high_water=4))
        for s in ("fifo", "read_priority")}
    fifo, rp = reps["fifo"], reps["read_priority"]
    assert fifo.counters.reads == rp.counters.reads
    assert fifo.counters.writes == rp.counters.writes
    assert fifo.programs == rp.programs
    assert fifo.latency.read_p99_ns > rp.latency.read_p99_ns


# ---------------------------------------------------------- latency sweep
# benchmarks/common.py run_event: 32 key pages on 8 chips, Poisson
# arrivals over 8 streams, bursts of 64, the write buffer at the sweep's
# high-water mark of 8; the op count cut from 1,200 to 300.
SWEEP_N_QUERIES, SWEEP_KEY_PAGES, SWEEP_CHIPS = 300, 32, 8


@pytest.mark.parametrize("qps,policy", [(1e5, "fifo"),
                                        (3e5, "read_priority"),
                                        (6e5, "fair_share")])
def test_latency_sweep_points_equal_to_jax(qps, policy):
    kw = dict(n_key_pages=SWEEP_KEY_PAGES, read_ratio=0.5, alpha=0.9,
              seed=1)
    wl = generate(SWEEP_N_QUERIES, **kw)
    jwl = jgenerate(SWEEP_N_QUERIES, **kw)
    pages = max(wl.n_index_pages // SWEEP_CHIPS + 1, 8)
    cfg = RunConfig.open_loop(qps, concurrency=8, scheduler=policy,
                              burst=64, write_buffer=True,
                              write_high_water=8, seed=1)
    got = replay(wl, make_backend("scalar", SimChipArray(
        n_chips=SWEEP_CHIPS, pages_per_chip=pages, device_seed=7)), cfg)
    want = jreplay(jwl, jmake_backend("scalar", JSimChipArray(
        n_chips=SWEEP_CHIPS, pages_per_chip=pages, device_seed=7)),
        _jconfig(cfg))
    _same_event_report(got, want)
    assert len(got.latency.read_latencies_ns) == got.counters.reads > 0


# --------------------------------------------------- backend independence
def test_event_timing_is_backend_independent():
    wl = generate(200, n_key_pages=8, read_ratio=0.6, alpha=0.9, seed=4,
                  scan_ratio=0.05)
    cfg = RunConfig.open_loop(2e5, concurrency=4, burst=16,
                              write_buffer=True, write_high_water=4)
    reps = [replay(wl, _mk("scalar", pages=8), cfg),
            replay(wl, _mk("batched", pages=8), cfg),
            replay(wl, ShardedSsdBackend.from_geometry(
                channels=2, dies_per_channel=2, pages_per_chip=8,
                device_seed=3, device="cpu"), cfg)]
    for r in reps[1:]:
        np.testing.assert_array_equal(r.read_values, reps[0].read_values)
        for f in LATENCY_FIELDS:
            np.testing.assert_array_equal(getattr(r.latency, f),
                                          getattr(reps[0].latency, f))
        assert r.energy.total_pj == reps[0].energy.total_pj
    assert reps[0].kernel_launches == 0 < reps[2].kernel_launches
