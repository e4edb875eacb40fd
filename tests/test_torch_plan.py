"""The port's range plans against the JAX package's, bit for bit.

The plain PyTorch ``sim_plan`` runs against the JAX package's Pallas plan
kernel in interpret mode; the range decompositions, the batched backend's
plan phase (bitmaps and every counter) and the YCSB-E scan replay run
against the JAX package's on the same inputs.  Inputs come from numpy
seeds and cross between the packages as numpy; tolerance is 0, since the
function is integer.
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import BatchedKernelBackend as JBatched
from repro.backend import make_backend as jmake_backend
from repro.core import bitweaving as jbw
from repro.core import range_query as jrq
from repro.core.commands import Command as JCommand
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.kernels.sim_plan.ops import plan_pass_rows as jplan_pass_rows
from repro.kernels.sim_plan.ops import sim_plan as jax_plan
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import BatchedKernelBackend, make_backend
from repro_torch.core import bitweaving, range_query
from repro_torch.core.bits import unpack_bitmap
from repro_torch.core.commands import Command, Op
from repro_torch.core.engine import SimChipArray
from repro_torch.core.range_query import (MaskedQuery, RangePlan,
                                          approximate_range,
                                          evaluate_plan_on_pages,
                                          evaluate_plan_per_pass, exact_range)
from repro_torch.frontend import RunConfig, replay
from repro_torch.kernels.layout import tensor_to_words, words_to_tensor
from repro_torch.kernels.sim_plan.ops import sim_plan
from repro_torch.kernels.sim_plan.ref import (PASS_EXCLUDE, PASS_INCLUDE,
                                              PASS_PAD, plan_pass_rows)
from repro_torch.kernels.sim_search.ref import stream_planes
from repro_torch.workload.ycsb import generate

N_PAGES = 12
ENTRIES = 300
KEY_SPAN = 2**48
STATS = ("searches", "plans", "flushes", "kernel_launches", "staged_pages",
         "staged_queries", "staged_bytes", "result_bytes")


def _t(a):
    return words_to_tensor(a, "cpu")


# ------------------------------------------------------------- sim_plan ref

def _plan_case(n_pages, n_groups, randomized, seed):
    """Domain keys with a planted run ``base + 0..63`` on page 0, slots
    100..163; group 0 is an exact range over it with an exclude pass on
    slot 102, group 1 has exclude passes only, group 2 an approximate
    range.  P = 8 pass rows each, PAD rows filling the rest."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, KEY_SPAN, (n_pages, 512), dtype=np.uint64)
    base = int(rng.integers(2**41, 2**47))
    keys[0, 100:164] = base + np.arange(64, dtype=np.uint64)
    plans = [RangePlan(exact_range(base + 1, base + 13).include,
                       exact_range(base + 2, base + 3).include),
             RangePlan((), exact_range(base, base + 4).include),
             approximate_range(base, base + 40)][:n_groups]
    q = np.zeros((n_groups, 8, 2), np.uint32)
    m, f = np.zeros_like(q), np.zeros((n_groups, 8), np.uint32)
    for g, plan in enumerate(plans):
        cmd = Command.plan(0, plan.include, plan.exclude)
        q[g], m[g], f[g] = plan_pass_rows(cmd.plan_include, cmd.plan_exclude,
                                          8)
    assert (f == PASS_PAD).any(axis=1).all()
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = rng.integers(0, 2**32, n_pages, dtype=np.uint64).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    if randomized:
        s_lo, s_hi = stream_planes(_t(ids), _t(seeds))
        lo ^= s_lo.numpy().astype(np.uint32)
        hi ^= s_hi.numpy().astype(np.uint32)
    want = np.stack([plan.evaluate(keys) for plan in plans])
    return (lo, hi, q, m, f, ids, seeds), want


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("n_groups", [1, 3])
@pytest.mark.parametrize("n_pages", [1, 3, 32, 70])
def test_sim_plan_ref_matches_pallas(n_pages, n_groups, randomized):
    args, want = _plan_case(n_pages, n_groups, randomized,
                            n_pages * 10 + n_groups)
    lo, hi, q, m, f, ids, seeds = args
    ref = np.asarray(jax_plan(lo, hi, q, m, f, page_block=8,
                              randomized=randomized, page_ids=ids,
                              page_seeds=seeds))
    got = tensor_to_words(sim_plan(*(_t(a) for a in args),
                                   randomized=randomized))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (n_groups, n_pages, 16)
    bits = np.unpackbits(got.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)
    np.testing.assert_array_equal(bits, want)
    assert bits[0, 0, 101] and not bits[0, 0, 102]   # include, exclude
    if n_groups > 1:
        assert not bits[1].any()                      # no include pass


def test_all_pad_group_and_pad_rows_match_nothing():
    """A PAD row (q = 0, m = 0) matches every slot by value; only its flag
    keeps it out, so an all-PAD group is all zero, as in the JAX kernel."""
    (lo, hi, _, _, _, ids, seeds), _ = _plan_case(3, 1, True, 4)
    q = np.zeros((2, 4, 2), np.uint32)
    m = np.zeros_like(q)
    f = np.zeros((2, 4), np.uint32)
    f[1, 2] = PASS_INCLUDE                 # a match-all include pass
    args = (lo, hi, q, m, f, ids, seeds)
    got = tensor_to_words(sim_plan(*(_t(a) for a in args), randomized=True))
    ref = np.asarray(jax_plan(*args[:5], page_block=8, randomized=True,
                              page_ids=ids, page_seeds=seeds))
    np.testing.assert_array_equal(got, ref)
    assert not got[0].any() and (got[1] == 0xFFFFFFFF).all()


def test_plan_pass_rows_equal_jax():
    inc = (((5, 6), (0xFF, 0xFFFF)), ((7, 0), (0xF, 0)))
    exc = (((1, 2), (3, 4)),)
    for a, b in zip(plan_pass_rows(inc, exc, 8),
                    jplan_pass_rows(inc, exc, 8)):
        np.testing.assert_array_equal(a, b)
    assert plan_pass_rows(inc, exc, 4)[2].tolist() == [
        PASS_INCLUDE, PASS_INCLUDE, PASS_EXCLUDE, PASS_PAD]
    with pytest.raises(ValueError):
        plan_pass_rows(inc, exc, 2)


# ------------------------------------------------------ range decomposition

def _pairs(plan):
    return [(q.query, q.mask) for q in plan.include], \
        [(q.query, q.mask) for q in plan.exclude]


@pytest.mark.parametrize("seed", range(6))
def test_range_plans_equal_jax(seed):
    rng = np.random.default_rng(seed)
    width = (64, 48, 16)[seed % 3]
    shift = 64 - width if seed % 2 else 0
    lo = int(rng.integers(0, 2**(width - 1)))
    hi = lo + 1 + int(rng.integers(0, 2**(width - 1)))
    keys = rng.integers(0, 2**63, 4000, dtype=np.uint64)
    for fn, jfn in ((exact_range, jrq.exact_range),
                    (approximate_range, jrq.approximate_range)):
        got = fn(lo, hi, shift=shift, width=width)
        want = jfn(lo, hi, shift=shift, width=width)
        assert _pairs(got) == _pairs(want)
        assert (got.exact, got.n_passes) == (want.exact, want.n_passes)
        np.testing.assert_array_equal(got.evaluate(keys),
                                      want.evaluate(keys))
        assert range_query.false_positive_bound(got, lo, hi, width) == \
            jrq.false_positive_bound(want, lo, hi, width)
    exact = exact_range(lo, hi, shift=shift, width=width)
    fields = (keys >> np.uint64(shift)) & np.uint64((1 << width) - 1)
    np.testing.assert_array_equal(exact.evaluate(keys),
                                  (fields >= lo) & (fields < hi))
    with pytest.raises(ValueError):
        exact_range(hi, lo, width=width)


@pytest.mark.parametrize("exact", [True, False])
def test_row_codec_equal_jax(exact):
    cols = [("region", 8), ("day", 16), ("price", 24)]
    codec = bitweaving.RowCodec([bitweaving.Column(n, w) for n, w in cols])
    ref = jbw.RowCodec([jbw.Column(n, w) for n, w in cols])
    assert (codec.shifts, codec.spare_bits) == (ref.shifts, ref.spare_bits)
    rng = np.random.default_rng(3)
    rows = {n: rng.integers(0, 2**w, 500, dtype=np.uint64) for n, w in cols}
    keys = codec.encode_rows(rows)
    np.testing.assert_array_equal(keys, ref.encode_rows(rows))
    assert codec.encode(region=3, day=9, price=77) == \
        ref.encode(region=3, day=9, price=77)
    for name, w in cols:
        lo = int(rng.integers(0, 2**(w - 1)))
        hi = lo + 1 + int(rng.integers(0, 2**(w - 1)))
        got, want = codec.range(name, lo, hi, exact=exact), \
            ref.range(name, lo, hi, exact=exact)
        assert _pairs(got) == _pairs(want)
        eq, jeq = codec.equals(name, lo), ref.equals(name, lo)
        assert (eq.query, eq.mask) == (jeq.query, jeq.mask)
        np.testing.assert_array_equal(got.evaluate(keys),
                                      want.evaluate(keys))
        np.testing.assert_array_equal(codec.decode_rows(keys, name),
                                      rows[name])
    with pytest.raises(ValueError):
        bitweaving.RowCodec([bitweaving.Column("a", 40),
                             bitweaving.Column("b", 40)])


# ------------------------------------------------------- batched plan phase

def _page_keys(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, KEY_SPAN, ENTRIES, dtype=np.uint64)
            for _ in range(N_PAGES)]


def _pair(page_keys, seed=31):
    port = SimChipArray(n_chips=4, pages_per_chip=8, device_seed=seed)
    ref = JSimChipArray(n_chips=4, pages_per_chip=8, device_seed=seed)
    for p, keys in enumerate(page_keys):
        port.program_entries(p, keys)
        ref.program_entries(p, keys)
    return BatchedKernelBackend(port, device="cpu"), JBatched(ref)


def _plans(page_keys):
    """The JAX package's plan cases (tests/test_plan_backend.py)."""
    allk = np.concatenate(page_keys)
    lo = int(np.percentile(allk, 35))
    hi = int(np.percentile(allk, 65))
    return {
        "exact": (lo, hi, True),
        "approx": (lo, hi, False),
        "exact_narrow": (lo, lo + 3, True),
        "include_only": ([(int(page_keys[0][0]), 2**64 - 1)], []),
        "match_all": ([(0, 0)], []),
    }


def _plan_both(spec):
    if len(spec) == 3:
        lo, hi, exact = spec
        port = (exact_range if exact else approximate_range)(lo, hi)
        ref = (jrq.exact_range if exact else jrq.approximate_range)(lo, hi)
        return port, ref
    inc, exc = spec
    return (RangePlan(tuple(MaskedQuery(*p) for p in inc),
                      tuple(MaskedQuery(*p) for p in exc)),
            jrq.RangePlan(tuple(jrq.MaskedQuery(*p) for p in inc),
                          tuple(jrq.MaskedQuery(*p) for p in exc)))


def _same_counters(port, ref):
    assert {k: getattr(port.stats, k) for k in STATS} == \
        {k: getattr(ref.stats, k) for k in STATS}
    for c, d in zip(port.chips.chips, ref.chips.chips):
        assert vars(c.counters) == vars(d.counters)


@pytest.fixture(scope="module")
def page_keys():
    return _page_keys()


@pytest.mark.parametrize("label", ["exact", "approx", "exact_narrow",
                                   "include_only", "match_all"])
def test_batched_plans_identical_to_jax(page_keys, label):
    port, ref = _pair(page_keys)
    plan, jplan = _plan_both(_plans(page_keys)[label])
    pages = list(range(N_PAGES))
    got = evaluate_plan_on_pages(port, plan, pages)
    np.testing.assert_array_equal(
        got, jrq.evaluate_plan_on_pages(ref, jplan, pages))
    _same_counters(port, ref)
    assert port.stats.kernel_launches == 1
    assert port.stats.staged_queries == plan.n_passes
    # ...the per-pass searches combined on the host give the same bitmaps,
    # and both equal direct evaluation of the plan on the stored keys.
    np.testing.assert_array_equal(
        evaluate_plan_per_pass(port, plan, pages), got)
    np.testing.assert_array_equal(
        jrq.evaluate_plan_per_pass(ref, jplan, pages), got)
    _same_counters(port, ref)
    for p in (0, N_PAGES - 1):
        bits = unpack_bitmap(got[p], 512)[8:8 + ENTRIES].astype(bool)
        np.testing.assert_array_equal(bits, plan.evaluate(page_keys[p]))


def test_plan_burst_is_one_launch_with_dedup(page_keys):
    """Many pages x two plans = ONE launch; identical plans on one page
    share a launch cell and cross once (64 B)."""
    port, ref = _pair(page_keys)
    plans = [(exact_range(1000, 2**40), jrq.exact_range(1000, 2**40)),
             (approximate_range(1000, 2**40),
              jrq.approximate_range(1000, 2**40))]
    tickets = []
    for be, k, C in ((port, 0, Command), (ref, 1, JCommand)):
        tickets.append([be.submit_plan(C.plan(p, pl[k].include,
                                              pl[k].exclude))
                        for pl in plans for p in range(N_PAGES)])
        be.flush()
    assert port.stats.kernel_launches == 1
    for a, b in zip(*tickets):
        np.testing.assert_array_equal(a.result().bitmap_words,
                                      b.result().bitmap_words)
    _same_counters(port, ref)
    cmd = Command.plan(3, plans[0][0].include)
    t1, t2 = port.submit_plan(cmd), port.submit_plan(cmd)
    rb = port.stats.result_bytes
    port.flush()
    assert t1.result() is t2.result()
    assert port.stats.result_bytes - rb == 64
    assert port.stats.kernel_launches == 2


def test_plan_result_bytes_drop_by_pass_count(page_keys):
    """Fused PLAN ships 64 B a page, the per-pass path 64 B a pass a page;
    the chip counts the passes as match ops either way."""
    port, _ = _pair(page_keys)
    plan, _ = _plan_both(_plans(page_keys)["exact"])
    assert plan.n_passes > 10
    pages = list(range(N_PAGES))
    searches = sum(c.counters.searches for c in port.chips.chips)
    before = port.stats.result_bytes
    evaluate_plan_on_pages(port, plan, pages)
    fused = port.stats.result_bytes - before
    assert sum(c.counters.searches for c in port.chips.chips) - searches \
        == plan.n_passes * N_PAGES
    before = port.stats.result_bytes
    evaluate_plan_per_pass(port, plan, pages)
    per_pass = port.stats.result_bytes - before
    assert fused == 64 * N_PAGES
    assert per_pass == 64 * plan.n_passes * N_PAGES
    assert per_pass // fused == plan.n_passes


def test_plan_ticket_survives_reprogram_between_flush_and_drain(page_keys):
    """The launch read the pre-write planes: a reprogram after the flush
    does not leak into the deferred result; a new plan sees the new image."""
    port, ref = _pair(page_keys)
    plan, jplan = _plan_both(_plans(page_keys)["exact"])
    t = port.submit_plan(Command.plan(2, plan.include, plan.exclude))
    port.flush()
    new = page_keys[2][::-1] // np.uint64(2)
    port.program_entries(2, new)
    want = jrq.evaluate_plan_on_pages(ref, jplan, [2])
    np.testing.assert_array_equal(t.result().bitmap_words, want[0])
    ref.program_entries(2, new)
    np.testing.assert_array_equal(
        evaluate_plan_on_pages(port, plan, [2]),
        jrq.evaluate_plan_on_pages(ref, jplan, [2]))
    _same_counters(port, ref)


def test_submit_plan_validation():
    be = make_backend("batched", SimChipArray(2, 4), device="cpu")
    with pytest.raises(ValueError):
        be.submit_plan(Command.search(0, 123))
    cmd = Command.plan(0, [(5, 0xFF)], [(1, 0x0F)])
    assert cmd.op is Op.PLAN and cmd.n_passes == 2
    cmd2 = Command.plan(0, [MaskedQuery(query=5, mask=0xFF)],
                        [MaskedQuery(query=1, mask=0x0F)])
    assert (cmd2.plan_include, cmd2.plan_exclude) == \
        (cmd.plan_include, cmd.plan_exclude)
    be.submit_plan(cmd)
    assert be.pending == 1


# ----------------------------------------------------------- YCSB-E replay

SCAN_COUNTERS = ("reads", "writes", "scans", "flushes", "kernel_launches",
                 "staged_bytes", "result_bytes", "programs")


@pytest.mark.parametrize("mix,fused", [
    (dict(read_ratio=0.7, scan_ratio=0.1, max_scan_len=40), True),
    (dict(read_ratio=0.7, scan_ratio=0.1, max_scan_len=40), False),
    (dict(read_ratio=0.0, scan_ratio=0.95, max_scan_len=100), True)])
def test_ycsb_scan_replay_identical_to_jax(mix, fused):
    wl = generate(150, n_key_pages=4, alpha=0.9, seed=5, **mix)
    jwl = jgenerate(150, n_key_pages=4, alpha=0.9, seed=5, **mix)
    np.testing.assert_array_equal(wl.scan_lens, jwl.scan_lens)
    scans = wl.ops == 2
    assert scans.sum() > 0
    got = replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                  device="cpu"),
                 RunConfig(burst=32, fused=fused))
    want = jreplay(jwl, jmake_backend("batched", JSimChipArray(4, 16, 3)),
                   JRunConfig(burst=32, fused=fused))
    np.testing.assert_array_equal(got.scan_counts, want.scan_counts)
    np.testing.assert_array_equal(got.read_values, want.read_values)
    np.testing.assert_array_equal(got.read_hits, want.read_hits)
    assert {c: getattr(got.counters, c) for c in SCAN_COUNTERS} == \
        {c: getattr(want.counters, c) for c in SCAN_COUNTERS}
    assert got.n_scans == int(scans.sum())
    n_keys = 4 * 504
    for qi in np.nonzero(scans)[0]:       # every stored key in the window
        lo = int(wl.keys[qi]) + 1
        assert got.scan_counts[qi] == \
            min(lo + int(wl.scan_lens[qi]), n_keys + 1) - lo
