"""The port's §IV-C reliability tier against the JAX package's, exactly.

Both packages run on the CPU: the port's kernel backends with
``device="cpu"`` (the plain PyTorch versions of the kernels), the JAX
package's batched backend as its own tests run it (Pallas in interpret
mode) for the flush-level cases and with ``use_kernel=False`` for the
replays.  Contracts, each with tolerance 0 (the tier is host numpy on both
sides, keyed on the same ``SeedSequence`` entropy):

  * ``FaultModel`` — the per-page error counts, the injected page images
    and the sense-noise masks are equal by ``==``; the analytic sense
    bounds are the same floats;
  * **error-path parity** — below-t body damage, header damage and
    header damage above the outer-code budget give the same per-command
    outcome (bitmap or typed ``UncorrectableReadError``) and the same
    ``ReliabilityStats`` on scalar, batched and sharded, equal to JAX's;
  * **replays** — verified (age 45, voting, refreshes), unverified (sense
    noise only) and write-buffer replays under faults: per-op values, hits
    and typed errors, refreshes and ``ReliabilityStats`` equal JAX's on
    the same backend;
  * **the BER sweep** — ``benchmarks/reliability_sweep.py``'s own
    configuration: every ``reliability_*`` counter equals the committed
    ``BENCH_reliability_sweep.baseline.json`` (read as data), with zero
    wrong results and zero per-op mismatches between backends.
"""
import dataclasses
import json
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import make_backend as jmake_backend
from repro.core.commands import Command as JCommand
from repro.core.ecc import EccConfig as JEccConfig
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.reliability import FaultModel as JFaultModel
from repro.reliability import ReliabilityPolicy as JReliabilityPolicy
from repro.reliability import ReliabilityState as JReliabilityState
from repro.reliability import UncorrectableReadError as JUncorrectable
from repro.reliability import majority_flip_prob as jmajority_flip_prob
from repro.reliability import (
    sense_false_negative_bound as jsense_false_negative_bound)
from repro.reliability import (
    sense_false_positive_bound as jsense_false_positive_bound)
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import make_backend
from repro_torch.core.commands import Command
from repro_torch.core.ecc import EccConfig
from repro_torch.core.engine import SimChipArray
from repro_torch.frontend import RunConfig, replay
from repro_torch.reliability import (FaultModel, ReliabilityPolicy,
                                     ReliabilityState, UncorrectableReadError,
                                     majority_flip_prob,
                                     sense_false_negative_bound,
                                     sense_false_positive_bound)
from repro_torch.workload.ycsb import generate

BACKENDS = ("scalar", "batched", "sharded")
T_CORRECTABLE = 40
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "BENCH_reliability_sweep.baseline.json"


def _port_backend(name, arr):
    return make_backend(name, arr, **({} if name == "scalar"
                                      else {"device": "cpu"}))


def _jax_backend(name, arr, use_kernel=False):
    return jmake_backend(name, arr, **({} if name == "scalar"
                                       else {"use_kernel": use_kernel}))


def _stats(rel) -> dict:
    return dataclasses.asdict(rel.stats)


# -------------------------------------------------------------- FaultModel
@pytest.mark.parametrize("kw", [dict(seed=5, base_ber=1e-3,
                                     retention_days=45.0),
                                dict(seed=11, base_ber=1e-4,
                                     retention_days=90.0, pe_cycles=6000),
                                dict(seed=0, base_ber=2e-4)])
def test_fault_model_draws_equal_jax(kw):
    port, ref = FaultModel(**kw), JFaultModel(**kw)
    assert port.raw_ber() == ref.raw_ber() and port.now_ns == ref.now_ns
    for chip_seed in (0, 3, 123, 2**40 + 7):
        for page in range(6):
            assert port.error_bits_for(chip_seed, page) \
                == ref.error_bits_for(chip_seed, page)


def test_fault_injection_images_equal_jax():
    arrs = (SimChipArray(n_chips=2, pages_per_chip=4, device_seed=3),
            JSimChipArray(n_chips=2, pages_per_chip=4, device_seed=3))
    for arr in arrs:
        for p in range(8):
            arr.program_entries(p, np.arange(1, 101, dtype=np.uint64))
    fm = dict(seed=9, base_ber=2e-4, retention_days=30.0)
    assert FaultModel(**fm).inject(arrs[0]) \
        == JFaultModel(**fm).inject(arrs[1]) > 0
    for pc, jc in zip(arrs[0].chips, arrs[1].chips):
        assert sorted(pc.pages) == sorted(jc.pages)
        for a in pc.pages:
            np.testing.assert_array_equal(pc.pages[a].raw, jc.pages[a].raw)
            assert pc.pages[a].injected_error_bits \
                == jc.pages[a].injected_error_bits


@pytest.mark.parametrize("sense_ber", [0.0, 1e-3, 5e-2])
def test_slot_noise_words_equal_jax(sense_ber):
    port = FaultModel(seed=11, sense_ber=sense_ber)
    ref = JFaultModel(seed=11, sense_ber=sense_ber)
    for args in ((0, 0, 0, 0), (17, 3, 2, 0xDEADBEEF), (5, 1, 0, 2**33 + 1)):
        got, want = port.slot_noise_words(*args), ref.slot_noise_words(*args)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_analytic_sense_bounds_equal_jax():
    for p in (1e-4, 5e-4, 1e-3, 0.2):
        for k in (1, 2, 3, 5):
            assert majority_flip_prob(p, k) == jmajority_flip_prob(p, k)
            assert sense_false_positive_bound(p, k) \
                == jsense_false_positive_bound(p, k)
            assert sense_false_negative_bound(p, k) \
                == jsense_false_negative_bound(p, k)
    assert majority_flip_prob(1e-3, 3) < 1e-3
    assert 0.0 < sense_false_positive_bound(1e-3, 3) \
        < sense_false_positive_bound(1e-3, 1) < 1.0


# ------------------------------------------- typed error channel / parity
def _reliable(arr_cls, mk, state, policy, ecc, name, corrupt):
    """Identically programmed backend with targeted corruption and a
    noise-free reliability tier attached (retry_fix_prob=0 pins the
    read-retry loop, so header damage above t is UNCORRECTABLE)."""
    arr = arr_cls(n_chips=2, pages_per_chip=6, device_seed=3)
    keys = {p: np.arange(p * 100 + 1, p * 100 + 81, dtype=np.uint64)
            for p in range(6)}
    for p, k in keys.items():
        arr.program_entries(p, k)
    corrupt(arr)
    backend = mk(name, arr)
    rel = state(policy(vote_k=1, ecc=ecc(retry_fix_prob=0.0)))
    rel.install(backend)
    return backend, rel, keys


def _outcome(fn, err):
    try:
        resp = fn()
    except err as e:
        return ("uncorrectable", e.page_addr)
    return ("ok", np.asarray(resp.bitmap_words).tolist(), resp.open_verdict)


@pytest.mark.parametrize("region,n_bits", [
    ((64, 4096), 8),                  # body-only, below t: correctable
    ((0, 64), 12),                    # header chunk: open must fall back
    ((0, 64), T_CORRECTABLE + 30),    # header dead + above t: typed error
])
def test_error_path_parity_across_backends(region, n_bits):
    def corrupt(arr):
        arr.chips[0].inject_bit_errors(
            0, n_bits, rng=np.random.default_rng(4), byte_region=region)

    outs = {}
    for name in BACKENDS:
        for pkg, args in (
                ("port", (SimChipArray, _port_backend, ReliabilityState,
                          ReliabilityPolicy, EccConfig, Command,
                          UncorrectableReadError)),
                ("jax", (JSimChipArray,
                         lambda n, a: jmake_backend(
                             n, a, **({"use_kernel": False}
                                      if n == "sharded" else {})),
                         JReliabilityState, JReliabilityPolicy, JEccConfig,
                         JCommand, JUncorrectable))):
            backend, rel, keys = _reliable(*args[:5], name, corrupt)
            cmd, err = args[5], args[6]
            per_cmd = [_outcome(lambda p=p: backend.search(
                cmd.search(p, int(keys[p][3]))), err) for p in range(6)]
            outs[pkg, name] = (per_cmd, _stats(rel))
    ref_cmds, ref_stats = outs["port", "scalar"]
    assert all(o[0] == "ok" for o in ref_cmds[1:])
    if n_bits > T_CORRECTABLE:
        assert ref_cmds[0] == ("uncorrectable", 0)
    else:
        assert ref_cmds[0][0] == "ok"
    for key, (cmds, stats) in outs.items():
        assert cmds == ref_cmds, key
        assert stats == ref_stats, key


def test_reprogram_clears_injected_errors():
    def corrupt(arr):
        arr.chips[0].inject_bit_errors(
            0, T_CORRECTABLE + 25, rng=np.random.default_rng(4),
            byte_region=(0, 64))

    for name in BACKENDS:
        backend, _, keys = _reliable(SimChipArray, _port_backend,
                                     ReliabilityState, ReliabilityPolicy,
                                     EccConfig, name, corrupt)
        with pytest.raises(UncorrectableReadError):
            backend.search(Command.search(0, int(keys[0][0])))
        backend.submit_program(0, keys[0])
        backend.flush()
        assert backend.chips.chips[0].pages[0].injected_error_bits == 0
        assert backend.search(Command.search(0, int(keys[0][0]))) \
            .match_count == 1


# ----------------------------------------------------- functional replays
def _pair(name, wl_kw, policy_kw, fault_kw, n_chips=2, **cfg):
    """The same reliable replay in both packages; returns both reports and
    reliability states."""
    out = []
    for gen, arr_cls, mk, state, policy, fault, cfg_cls, run in (
            (generate, SimChipArray, _port_backend, ReliabilityState,
             ReliabilityPolicy, FaultModel, RunConfig, replay),
            (jgenerate, JSimChipArray, _jax_backend, JReliabilityState,
             JReliabilityPolicy, JFaultModel, JRunConfig, jreplay)):
        wl = gen(**wl_kw)
        arr = arr_cls(n_chips=n_chips, pages_per_chip=max(
            wl.n_index_pages // n_chips + 1, 8), device_seed=3)
        rel = state(policy(**policy_kw), fault(**fault_kw))
        rep = run(wl, mk(name, arr), cfg_cls.reliable(rel, **cfg))
        out.append((rep, rel))
    return out


def _same_replay(port, ref):
    (p, prel), (r, rrel) = port, ref
    for f in ("read_values", "read_hits", "read_errors"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f),
                                      err_msg=f)
    assert p.refreshes == r.refreshes
    assert p.n_read_errors == r.n_read_errors
    assert _stats(prel) == _stats(rrel)
    for f in ("flushes", "programs", "kernel_launches", "result_bytes"):
        assert getattr(p, f) == getattr(r, f), f


def _oracle(wl):
    return (wl.keys.astype(np.uint64) + np.uint64(1)) \
        * np.uint64(0x9E3779B97F4A7C15) | np.uint64(1)


VERIFIED = dict(verify_hits=True, fallback_on_miss=True, vote_k=3)
AGED = dict(seed=11, base_ber=1e-4, retention_days=45.0, sense_ber=2e-4)


@pytest.mark.parametrize("name", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_verified_replay_equals_jax(name, fused):
    wl_kw = dict(n_queries=48, n_key_pages=4, read_ratio=1.0, alpha=0.8,
                 seed=2)
    port, ref = _pair(name, wl_kw, VERIFIED, AGED, burst=16, fused=fused)
    _same_replay(port, ref)
    rep = port[0]
    ok = rep.read_hits & (rep.read_values == _oracle(generate(**wl_kw)))
    assert np.all(ok | rep.read_errors), "silent wrong result escaped"
    # age 45 > the 30-day refresh margin: stale pages were rewritten
    assert rep.refreshes > 0 and rep.refreshes == port[1].stats.refreshes


@pytest.mark.parametrize("vote_k", [1, 3])
def test_unverified_noise_replay_equals_jax(vote_k):
    wl_kw = dict(n_queries=64, n_key_pages=4, read_ratio=1.0, alpha=0.8,
                 seed=3)
    policy = dict(verify_hits=False, fallback_on_miss=False, vote_k=vote_k)
    fault = dict(seed=11, base_ber=0.0, sense_ber=1e-3)
    for name in BACKENDS:
        port, ref = _pair(name, wl_kw, policy, fault, burst=16, fused=True)
        _same_replay(port, ref)
    wrong = int(np.sum(~(port[0].read_hits & (
        port[0].read_values == _oracle(generate(**wl_kw))))))
    if vote_k == 1:
        assert wrong > 0, "noise path not exercised"


@pytest.mark.parametrize("name", ["scalar", "batched"])
@pytest.mark.parametrize("buffered", [False, True])
def test_write_buffer_replay_under_faults_equals_jax(name, buffered):
    wl_kw = dict(n_queries=48, n_key_pages=4, read_ratio=0.75, alpha=0.8,
                 seed=4)
    port, ref = _pair(name, wl_kw, VERIFIED, AGED, burst=16, fused=True,
                      write_buffer=buffered)
    _same_replay(port, ref)


# ------------------------------------------------------- the BER sweep
def _sweep_run(name, wl, policy, fault):
    arr = SimChipArray(n_chips=4, pages_per_chip=max(
        wl.n_index_pages // 4 + 1, 8), device_seed=3)
    rel = ReliabilityState(policy, fault)
    rep = replay(wl, _port_backend(name, arr),
                 RunConfig.reliable(rel, burst=64, fused=True))
    return rep, rel


def test_reliability_sweep_counters_equal_baseline():
    """``benchmarks/reliability_sweep.py``'s configuration on the port:
    240 read-only ops over 12 key pages on 4 chips, fault seed 11, device
    seed 3, base BER 1e-4 at ages 0/45/90 with vote_k 3 on every backend,
    then sense BER 5e-4 unverified at vote_k 1 and 3 on the scalar
    backend.  Every counter equals the committed baseline."""
    base = {m["name"]: m["value"]
            for m in json.loads(BASELINE.read_text())["metrics"]}
    wl = generate(240, n_key_pages=12, read_ratio=1.0, alpha=0.9, seed=7)
    oracle = _oracle(wl)
    got = {}
    wrong = mismatch = 0
    for age in (0, 45, 90):
        fault = FaultModel(seed=11, base_ber=1e-4,
                           retention_days=float(age), sense_ber=2e-4)
        policy = ReliabilityPolicy(**VERIFIED)
        runs = {n: _sweep_run(n, wl, policy, fault) for n in BACKENDS}
        for rep, _ in runs.values():
            ok_hit = rep.read_hits & (rep.read_values == oracle)
            wrong += int(np.sum(~(ok_hit | rep.read_errors)))
        ref, rel = runs["scalar"]
        got[f"reliability_retries_age{age}"] = rel.stats.retries
        got[f"reliability_fallback_reads_age{age}"] = \
            rel.stats.fallback_reads
        got[f"reliability_uncorrectable_age{age}"] = rel.stats.uncorrectable
        got[f"reliability_refreshes_age{age}"] = ref.refreshes
        for name in BACKENDS[1:]:
            r = runs[name][0]
            for f in ("read_values", "read_hits", "read_errors"):
                mismatch += int(np.sum(getattr(r, f) != getattr(ref, f)))
    got["reliability_wrong_results_verified"] = wrong
    got["reliability_backend_mismatch"] = mismatch
    for vote_k in (1, 3):
        rep, _ = _sweep_run(
            "scalar", wl, ReliabilityPolicy(verify_hits=False,
                                            fallback_on_miss=False,
                                            vote_k=vote_k),
            FaultModel(seed=11, base_ber=0.0, sense_ber=5e-4))
        got[f"reliability_fp_ops_unverified_k{vote_k}"] = int(np.sum(
            rep.read_hits & (rep.read_values != oracle)))
        got[f"reliability_fn_ops_unverified_k{vote_k}"] = int(np.sum(
            ~rep.read_hits & ~rep.read_errors))
    assert got == base
