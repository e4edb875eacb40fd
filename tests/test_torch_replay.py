"""The port's YCSB replay against the JAX package's, end to end.

The same workload replays through ``repro.frontend.replay`` on the JAX
package's batched backend (Pallas in interpret mode) and through
``repro_torch.frontend.replay`` on the port's batched backend with
``device="cpu"``; read values, hits and counters must agree exactly.
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import make_backend as jmake_backend
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import make_backend
from repro_torch.core.engine import SimChipArray
from repro_torch.frontend import RunConfig, replay
from repro_torch.workload.ycsb import generate

COUNTERS = ("reads", "writes", "flushes", "kernel_launches", "staged_bytes",
            "result_bytes", "programs")


@pytest.fixture(scope="module")
def workload():
    wl = generate(300, n_key_pages=6, read_ratio=0.8, alpha=0.5, seed=11)
    ref = jgenerate(300, n_key_pages=6, read_ratio=0.8, alpha=0.5, seed=11)
    for f in ("ops", "key_pages", "value_pages", "keys"):
        np.testing.assert_array_equal(getattr(wl, f), getattr(ref, f))
    return wl, ref


@pytest.mark.parametrize("fused", [False, True])
def test_ycsb_replay_identical_to_jax(workload, fused):
    wl, jwl = workload
    got = replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                  device="cpu"),
                 RunConfig(burst=32, fused=fused))
    want = jreplay(jwl, jmake_backend("batched", JSimChipArray(4, 16, 3)),
                   JRunConfig(burst=32, fused=fused))
    np.testing.assert_array_equal(got.read_values, want.read_values)
    np.testing.assert_array_equal(got.read_hits, want.read_hits)
    assert got.read_hits[wl.ops == 0].all()
    assert {c: getattr(got.counters, c) for c in COUNTERS} == \
        {c: getattr(want.counters, c) for c in COUNTERS}
    if fused:
        assert got.kernel_launches == got.flushes


def test_split_and_fused_agree_with_serial_oracle(workload):
    wl, _ = workload
    values = (np.arange(1, 6 * 504 + 1, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    want = np.zeros(len(wl.ops), np.uint64)
    for qi, (op, k) in enumerate(zip(wl.ops, wl.keys)):
        if op == 0:
            want[qi] = values[k]
        else:
            values[k] = np.uint64(qi * 2 + 1)
    reads = wl.ops == 0
    reps = [replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                    device="cpu"),
                   RunConfig(burst=16, fused=fused)) for fused in (0, 1)]
    for r in reps:
        np.testing.assert_array_equal(r.read_values[reads], want[reads])
    assert reps[0].kernel_launches == 2 * reps[1].kernel_launches


# The name is from before slice 7, when this path raised; it is kept so
# the test's ID stays stable across the port's slices.
@pytest.mark.parametrize("knob", [dict(mode="event"),
                                  dict(reliability="verified, age 45"),
                                  dict(faults="dead chip 1"),
                                  dict(deadline_ns=1e6),
                                  dict(hedge_quantile=0.9),
                                  dict(shed_capacity=4)])
def test_unported_knobs_refused_at_construction(knob):
    """Every knob of the JAX package's ``RunConfig`` is ported: each
    constructs and replays equal to JAX (values, hits, typed errors, the
    reliability and fault counters).  What the JAX package refuses at
    construction the port refuses too: the event frontend's robustness
    knobs in serial mode, an object that is no ``FaultSchedule``."""
    from repro.reliability import FaultModel as JFaultModel
    from repro.reliability import FaultSchedule as JFaultSchedule
    from repro.reliability import ReliabilityPolicy as JReliabilityPolicy
    from repro.reliability import ReliabilityState as JReliabilityState
    from repro_torch.reliability import (FaultModel, FaultSchedule,
                                         ReliabilityPolicy, ReliabilityState)

    wl = generate(40, n_key_pages=2, read_ratio=0.8, alpha=0.5, seed=3)
    jwl = jgenerate(40, n_key_pages=2, read_ratio=0.8, alpha=0.5, seed=3)
    if knob == dict(mode="event"):
        # The event frontend is ported: the knob constructs and replays.
        rep = replay(wl, SimChipArray(2, 4), RunConfig(**knob))
        assert rep.source == "event" and rep.read_hits[wl.ops == 0].all()
        return
    (field, value), = knob.items()
    name, kw, jkw = "batched", dict(fused=True), dict(fused=True)
    if field == "reliability":
        fault = dict(seed=11, base_ber=1e-4, retention_days=45.0,
                     sense_ber=2e-4)
        kw[field] = ReliabilityState(ReliabilityPolicy(vote_k=3),
                                     FaultModel(**fault))
        jkw[field] = JReliabilityState(JReliabilityPolicy(vote_k=3),
                                       JFaultModel(**fault))
    elif field == "faults":
        name = "sharded"
        kw[field] = FaultSchedule.dead_chip(chip=1, seed=3)
        jkw[field] = JFaultSchedule.dead_chip(chip=1, seed=3)
        with pytest.raises(ValueError):
            RunConfig(faults=object())
        with pytest.raises(ValueError):
            JRunConfig(faults=object())
    else:
        for cfg in (RunConfig, JRunConfig):
            with pytest.raises(ValueError, match="needs mode='event'"):
                cfg(**knob)
        kw.update(mode="event", **knob)
        jkw.update(mode="event", **knob)
    got = replay(wl, make_backend(name, SimChipArray(4, 16, 3),
                                  device="cpu"), RunConfig(**kw))
    want = jreplay(jwl, jmake_backend(name, JSimChipArray(4, 16, 3),
                                      use_kernel=False), JRunConfig(**jkw))
    for f in ("read_values", "read_hits"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for section in ("reliability", "faults"):
        a, b = getattr(got, section), getattr(want, section)
        for f in ("read_errors", "op_errors"):
            if hasattr(a, f):
                np.testing.assert_array_equal(getattr(a, f),
                                              getattr(b, f))
        if section == "reliability" and a.stats is not None:
            assert vars(a.stats) == vars(b.stats)
    assert all(getattr(got.faults, f) == getattr(want.faults, f)
               for f in ("failovers", "degraded_ops", "shed_requests",
                         "replica_programs", "n_op_errors", "timeouts"))
    if field == "faults":
        # No replicas: the dead chip's reads fail typed, none wrong.
        errs = got.faults.op_errors
        assert errs.any() and not got.read_hits[errs].any()


def test_write_buffer_knob_constructs_and_runs(workload):
    """The §VI write buffer is ported: the knob constructs, and a buffered
    replay returns what the eager one does."""
    wl, _ = workload
    reps = [replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                    device="cpu"),
                   RunConfig(burst=32, write_buffer=wb, write_high_water=4))
            for wb in (False, True)]
    np.testing.assert_array_equal(reps[0].read_values, reps[1].read_values)
    assert reps[1].write_flushes > 0 and reps[1].buffer_read_hits > 0


@pytest.mark.parametrize("bad", [dict(burst=0), dict(concurrency=2),
                                 dict(scheduler="nonesuch"),
                                 dict(max_retries=-1)])
def test_invalid_knobs_refused(bad):
    with pytest.raises(ValueError):
        RunConfig(**bad)


def test_config_keeps_every_field_of_the_jax_config():
    import dataclasses
    assert [f.name for f in dataclasses.fields(RunConfig)] == \
        [f.name for f in dataclasses.fields(JRunConfig)]
    assert RunConfig.eager(burst=8).with_(fused=True).fused


@pytest.mark.parametrize("fused", [False, True])
def test_replay_releases_the_backend(workload, fused):
    """Once the caller drops the backend, its plane arena goes at once, not
    at the next garbage collection: replays run one after another keep
    one arena alive, not several."""
    import weakref
    wl, _ = workload
    be = make_backend("batched", SimChipArray(4, 16, 3), device="cpu")
    replay(wl, be, RunConfig(burst=32, fused=fused))
    store = weakref.ref(be.store)
    del be
    assert store() is None


def test_scans_and_bare_chip_arrays_raise_not_implemented():
    """Scans are ported (one fused plan launch a scan), and a bare chip
    array replays on the scalar reference backend with the batched
    backend's values and no launch."""
    wl = generate(50, n_key_pages=2, read_ratio=0.5, alpha=0.0, seed=1,
                  scan_ratio=0.3)
    be = make_backend("batched", SimChipArray(2, 4), device="cpu")
    rep = replay(wl, be, RunConfig(fused=True))
    scans = wl.ops == 2
    assert rep.n_scans == int(scans.sum()) > 0
    assert (rep.scan_counts[scans] > 0).all()
    assert be.stats.plans == rep.n_scans
    wl = generate(50, n_key_pages=2, read_ratio=0.5, alpha=0.0, seed=1)
    bare = replay(wl, SimChipArray(2, 4))
    batched = replay(wl, make_backend("batched", SimChipArray(2, 4),
                                      device="cpu"))
    np.testing.assert_array_equal(bare.read_values, batched.read_values)
    assert bare.read_hits[wl.ops == 0].all()
    assert bare.kernel_launches == 0 < batched.kernel_launches
