"""The port's scalar reference backend and matching specification against
the JAX package's, and against the port's own batched backend.

Three comparisons, each exact (tolerance 0; every function is integer):

  * the port's ``ScalarBackend`` against the JAX package's, command by
    command (searches, gathers, lookups, plans) with equal responses,
    ``BackendStats`` and per-chip counters;
  * the port's scalar backend against the port's batched backend on
    ``device="cpu"``, bit for bit, over the sweeps of
    ``tests/test_backend_parity.py``;
  * ``replay`` of YCSB-B, -E and -A on a bare ``SimChipArray`` (the scalar
    backend) against the JAX package's scalar replay, report for report.

``match_slots``/``search_page``/``gather_chunks`` run against the JAX
package's under hypothesis where it is installed.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import ScalarBackend as JScalar
from repro.core import match as jmatch
from repro.core.commands import Command as JCommand
from repro.core.commands import Op as JOp
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import (BackendStats, BatchedKernelBackend,
                                 MatchBackend, ScalarBackend, as_backend,
                                 make_backend)
from repro_torch.core import match
from repro_torch.core.bits import (bytes_to_slot_words,
                                   chunk_bitmap_from_slot_bitmap, pair_to_u64)
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.page import mask_header_slots
from repro_torch.core.range_query import (approximate_range,
                                          evaluate_plan_on_pages, exact_range)
from repro_torch.frontend import RunConfig, replay
from repro_torch.workload.ycsb import generate

N_PAGES = 12
ENTRIES_PER_PAGE = 300
FULL = 2**64 - 1
STATS = [f.name for f in dataclasses.fields(BackendStats)]


def _page_keys(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 2**62, ENTRIES_PER_PAGE, dtype=np.uint64)
            for _ in range(N_PAGES)]


def _arrays(page_keys, make, n_chips=5, per_chip=8, seed=31):
    arrays = []
    for cls in make:
        arr = cls(n_chips=n_chips, pages_per_chip=per_chip, device_seed=seed)
        for p, keys in enumerate(page_keys):
            arr.program_entries(p, keys)
        arrays.append(arr)
    return arrays


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


def _header_word(*arrays):
    """Page 2's first header slot, read (and counted) on every array."""
    words = [bytes_to_slot_words(a.read_full(2).plain)[0] for a in arrays]
    assert all(np.array_equal(w, words[0]) for w in words)
    return pair_to_u64(*words[0])


def _burst(page_keys, header, seed=1):
    """One mixed burst: searches (planted, masked, match-all), gathers
    (random, empty, full), lookups (hits at later slots, a masked query
    whose first user match is past the first chunk, a header-only match,
    misses) and plans (include, exclude, differing pass counts)."""
    rng = np.random.default_rng(seed)
    half = N_PAGES // 2
    cmds = []
    for _ in range(24):
        p = int(rng.integers(0, N_PAGES))
        if rng.random() < 0.5:
            q, m = int(page_keys[p][rng.integers(0, ENTRIES_PER_PAGE)]), FULL
        else:
            q = int(rng.integers(1, 2**62))
            m = int(rng.integers(0, 2**64, dtype=np.uint64))
        cmds.append(Command.search(p, q, m))
    cmds.append(Command.search(0, 0, 0))
    for p in range(N_PAGES):
        cmds.append(Command.gather(p, int(rng.integers(0, 2**64,
                                                       dtype=np.uint64))))
    cmds += [Command.gather(0, 0), Command.gather(1, FULL)]
    for kp in range(half):
        vp = kp + half
        cmds.append(Command.lookup(kp, vp, int(page_keys[kp][-1])))
        cmds.append(Command.lookup(kp, vp, int(page_keys[kp][250])))
        cmds.append(Command.lookup(kp, vp, int(rng.integers(2**62, 2**63))))
    cmds.append(Command.lookup(2, 2 + half, header))
    cmds.append(Command.lookup(3, 3 + half, int(page_keys[3][100]) & 0xF,
                               0xF))
    allk = np.concatenate(page_keys)
    lo, hi = int(np.percentile(allk, 35)), int(np.percentile(allk, 65))
    for p in range(0, N_PAGES, 3):
        cmds.append(Command.plan(p, exact_range(lo, hi).include,
                                 exact_range(lo, hi).exclude))
        cmds.append(Command.plan(p, approximate_range(lo, hi).include,
                                 approximate_range(lo, hi).exclude))
        cmds.append(Command.plan(p, [(int(page_keys[p][0]), FULL)],
                                 [(int(page_keys[p][0]), FULL)]))
        cmds.append(Command.plan(p, [(0, 0)]))
    rng.shuffle(cmds)
    return cmds


def _submit(be, cmds, convert=lambda c: c):
    return [getattr(be, f"submit_{c.op.name.lower()}")(convert(c))
            for c in cmds]


# ------------------------------------------------- scalar: port against JAX

def test_scalar_backend_identical_to_jax_command_by_command():
    page_keys = _page_keys()
    port_arr, ref_arr = _arrays(page_keys, (SimChipArray, JSimChipArray))
    port, ref = ScalarBackend(port_arr), JScalar(ref_arr)
    cmds = _burst(page_keys, _header_word(port_arr, ref_arr))
    tp, tr = _submit(port, cmds), _submit(ref, cmds, _jcmd)
    assert port.pending == ref.pending == len(cmds)
    port.flush()
    ref.flush()
    kinds = set()
    for c, a, b in zip(cmds, tp, tr):
        _same(a.result(), b.result())
        kinds.add(c.op.name)
    assert kinds == {"SEARCH", "GATHER", "LOOKUP", "PLAN"}
    _same_stats(port, ref)
    assert port.stats.flushes == 1 and port.stats.kernel_launches == 0


def test_scalar_lookup_edge_rows_equal_jax():
    """A header-only match resolves as a miss with the header bits set; a
    masked query whose first user match lies past chunk 1 picks that slot;
    a miss has no slot — in both packages."""
    page_keys = _page_keys()
    port_arr, ref_arr = _arrays(page_keys, (SimChipArray, JSimChipArray))
    port, ref = ScalarBackend(port_arr), JScalar(ref_arr)
    cmds = [Command.lookup(2, 8, _header_word(port_arr, ref_arr)),
            Command.lookup(1, 7, int(page_keys[1][250])),
            Command.lookup(4, 10, 2**63 + 5)]
    got = [port.lookup(c) for c in cmds]
    want = [ref.lookup(_jcmd(c)) for c in cmds]
    for a, b in zip(got, want):
        _same(a, b)
    assert got[0].value_slot is None and got[0].search.match_count > 0
    assert not mask_header_slots(got[0].search.bitmap_words).any()
    assert got[1].value_slot == 8 + 250
    assert got[2].value_slot is None and got[2].search.match_count == 0
    _same_stats(port, ref)


def test_scalar_deferred_programs_flush_first_like_jax():
    """Queued programs run before the burst's commands, coalescing
    last-wins, in both packages."""
    page_keys = _page_keys()
    port_arr, ref_arr = _arrays(page_keys, (SimChipArray, JSimChipArray))
    port, ref = ScalarBackend(port_arr), JScalar(ref_arr)
    new = np.arange(10, 60, dtype=np.uint64)
    for be in (port, ref):
        be.submit_program(5, new[::-1])
        be.submit_program(5, new)
    tp = port.submit_search(Command.search(5, 17))
    tr = ref.submit_search(_jcmd(Command.search(5, 17)))
    port.flush()
    ref.flush()
    _same(tp.result(), tr.result())
    assert tp.result().match_count == 1
    _same_stats(port, ref)
    assert port.stats.programs == 1 and port.stats.programs_coalesced == 1


def test_make_backend_scalar_and_as_backend():
    arr = SimChipArray(2, 4)
    be = make_backend("scalar", arr)
    assert isinstance(be, ScalarBackend) and be.chips is arr
    assert isinstance(as_backend(arr), ScalarBackend)
    assert as_backend(be) is be
    batched = make_backend("batched", arr, device="cpu")
    assert as_backend(batched) is batched
    assert isinstance(batched, MatchBackend)


# ------------------------------------------ scalar against batched, the port

@pytest.fixture(scope="module")
def backends():
    page_keys = _page_keys()
    arr_s, arr_b = _arrays(page_keys, (SimChipArray, SimChipArray))
    return (ScalarBackend(arr_s), BatchedKernelBackend(arr_b, device="cpu"),
            page_keys)


@pytest.mark.parametrize("sweep", ["search", "gather", "lookup", "plan",
                                   "mixed"])
def test_scalar_and_batched_bit_identical(backends, sweep):
    sb, bb, page_keys = backends
    cmds = _burst(page_keys, _header_word(sb.chips, bb.chips),
                  seed=len(sweep))
    if sweep != "mixed":
        cmds = [c for c in cmds if c.op.name == sweep.upper()]
    ts, tb = _submit(sb, cmds), _submit(bb, cmds)
    launches = bb.stats.kernel_launches
    sb.flush()
    bb.flush()
    kinds = len({c.op.name for c in cmds})
    assert bb.stats.kernel_launches == launches + kinds
    for a, b in zip(ts, tb):
        _same(a.result(), b.result())


def test_scalar_and_batched_range_plan(backends):
    sb, bb, page_keys = backends
    lo = int(np.percentile(page_keys[0], 30))
    hi = int(np.percentile(page_keys[0], 60))
    plan = exact_range(lo, hi, width=64)
    pages = list(range(N_PAGES))
    np.testing.assert_array_equal(evaluate_plan_on_pages(sb, plan, pages),
                                  evaluate_plan_on_pages(bb, plan, pages))


def test_scalar_and_batched_search_then_gather(backends):
    """The Fig 8 point-lookup command sequence on both."""
    sb, bb, page_keys = backends
    q = int(page_keys[3][17])
    got = []
    for be in (sb, bb):
        resp = be.search(Command.search(3, q))
        bitmap = mask_header_slots(resp.bitmap_words)
        cb = int(pair_to_u64(*chunk_bitmap_from_slot_bitmap(bitmap)))
        got.append((resp, be.gather(Command.gather(3, cb))))
    _same(*[g[0] for g in got])
    _same(*[g[1] for g in got])
    assert got[0][1].parity_ok.all()


def test_scalar_and_batched_see_reprograms():
    """program -> search -> reprogram -> search reflects the new image on
    both backends; the batched one restages exactly the dirty row."""
    rng = np.random.default_rng(9)
    keys_a = rng.integers(1, 2**62, 100, dtype=np.uint64)
    keys_b = rng.integers(1, 2**62, 100, dtype=np.uint64)
    arrays = [SimChipArray(n_chips=3, pages_per_chip=8, device_seed=17)
              for _ in range(2)]
    pair = [ScalarBackend(arrays[0]),
            BatchedKernelBackend(arrays[1], device="cpu")]
    for arr in arrays:
        for p in range(6):
            arr.program_entries(p, keys_a)
    probe = Command.search(2, int(keys_b[7]))
    first = [be.search(probe) for be in pair]
    _same(*first)
    assert first[0].match_count == 0
    warm = pair[1].stats.staged_bytes
    for arr in arrays:
        arr.program_entries(2, keys_b)
    second = [be.search(probe) for be in pair]
    _same(*second)
    assert second[0].match_count == 1
    assert pair[1].stats.staged_bytes - warm == 4096


@pytest.mark.parametrize("fused", [False, True])
def test_scalar_and_batched_replay_identical(fused):
    wl = generate(300, n_key_pages=6, read_ratio=0.8, alpha=0.5, seed=11)
    reps = {name: replay(wl, make_backend(name, SimChipArray(4, 16, 3),
                                          **kw),
                         RunConfig(burst=32, fused=fused))
            for name, kw in (("scalar", {}), ("batched",
                                              {"device": "cpu"}))}
    s, b = reps["scalar"], reps["batched"]
    np.testing.assert_array_equal(s.read_values, b.read_values)
    np.testing.assert_array_equal(s.read_hits, b.read_hits)
    assert s.read_hits[wl.ops == 0].all()
    assert s.kernel_launches == 0 < b.kernel_launches
    assert (s.flushes, s.result_bytes) == (b.flushes, b.result_bytes)


# ------------------------------------- replay on a bare chip array, vs JAX

REPORT = ("reads", "writes", "scans", "flushes", "kernel_launches",
          "staged_bytes", "result_bytes", "programs", "write_flushes",
          "buffer_read_hits")


@pytest.mark.parametrize("mix", ["B", "E", "A"])
def test_bare_chip_array_replay_identical_to_jax(mix):
    gen = dict(n_key_pages=6, alpha=0.5, seed=11, max_scan_len=40)
    gen.update({"B": dict(read_ratio=0.95), "E": dict(read_ratio=0.0,
                                                      scan_ratio=0.95),
                "A": dict(read_ratio=0.5)}[mix])
    cfg = dict(burst=32, fused=True)
    if mix == "A":
        cfg.update(write_buffer=True, write_high_water=4)
    wl, jwl = generate(300, **gen), jgenerate(300, **gen)
    got = replay(wl, SimChipArray(4, 16, 3), RunConfig(**cfg))
    want = jreplay(jwl, JSimChipArray(4, 16, 3), JRunConfig(**cfg))
    np.testing.assert_array_equal(got.read_values, want.read_values)
    np.testing.assert_array_equal(got.read_hits, want.read_hits)
    if mix == "E":
        np.testing.assert_array_equal(got.scan_counts, want.scan_counts)
        assert got.n_scans > 0
    assert {k: getattr(got.counters, k) for k in REPORT} == \
        {k: getattr(want.counters, k) for k in REPORT}
    assert got.kernel_launches == 0


# ---------------------------------------------- matching spec, vs JAX

try:            # hypothesis is an optional dev dependency
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = None

if given is None:
    def test_match_spec_equal_jax_needs_hypothesis():
        pytest.importorskip("hypothesis")
else:
    u32s = st.integers(0, 2**32 - 1)

    @settings(max_examples=40, deadline=None)
    @given(st.integers(0, 2**32 - 1), u32s, u32s, u32s)
    def test_match_slots_and_search_page_equal_jax(seed, q_lo, q_hi, m_lo):
        rng = np.random.default_rng(seed)
        words = rng.integers(0, 2**32, (3, 512, 2), dtype=np.uint64).astype(
            np.uint32)
        words[1, 77] = [q_lo, q_hi]            # a planted exact match
        q = np.array([q_lo, q_hi], np.uint32)
        m = np.array([m_lo, m_lo ^ q_hi], np.uint32)
        got = match.match_slots(words, q, m)
        want = jmatch.match_slots(words, q, m)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert got[1, 77] == 1
        np.testing.assert_array_equal(match.search_page(words, q, m),
                                      jmatch.search_page(words, q, m))
        np.testing.assert_array_equal(
            match.search_to_chunk_bitmap(words[0], q, m),
            jmatch.search_to_chunk_bitmap(words[0], q, m))

    @settings(max_examples=40, deadline=None)
    @given(st.integers(0, 2**32 - 1), st.integers(0, 2**64 - 1),
           st.integers(1, 80))
    def test_gather_chunks_equal_jax(seed, bitmap, max_out):
        rng = np.random.default_rng(seed)
        chunks = rng.integers(0, 2**31, (64, 16), dtype=np.int64)
        bm = np.array([bitmap & 0xFFFFFFFF, bitmap >> 32], np.uint32)
        out, count = match.gather_chunks(chunks, bm, max_out)
        jout, jcount = jmatch.gather_chunks(chunks, bm, max_out)
        np.testing.assert_array_equal(out, jout)
        assert int(count) == int(jcount) == min(bin(bitmap).count("1"), 64)
