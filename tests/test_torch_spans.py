"""The span recorder (``repro_torch.spans``), its sites on the SiM path and
the copy counter (``kernels/layout.COPIES``), on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.backend import make_backend
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.frontend import RunConfig, replay
from repro_torch.kernels import layout
from repro_torch.workload.ycsb import generate


@pytest.fixture(autouse=True)
def clean_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture
def ticking(monkeypatch):
    """A span clock that moves 10 ns a reading."""
    t = iter(range(0, 10**9, 10))
    monkeypatch.setattr(spans, "_clock", lambda: next(t))


def _names(recs):
    return [r.name for r in recs]


# ---------------------------------------------------------- the recorder
def test_nesting_parent_and_self_time(ticking):
    spans.enable()
    spans.mark()
    a = spans.begin("a", 7)                 # t 0
    b = spans.begin("b")                    # t 10
    spans.end(b)                            # t 20
    c = spans.begin("c")                    # t 30
    d = spans.begin("d")                    # t 40
    spans.end(d)                            # t 50
    spans.end(c)                            # t 60
    spans.end(a)                            # t 70
    spans.disable()
    assert spans.totals() == {"a": (1, 70, 30), "b": (1, 10, 10),
                              "c": (1, 30, 20), "d": (1, 10, 10)}
    recs = {r.name: r for r in spans.records()}
    assert _names(spans.records()) == ["b", "d", "c", "a"]
    assert recs["a"].parent is None
    assert recs["b"].parent == recs["c"].parent == recs["a"].id
    assert recs["d"].parent == recs["c"].id
    # Children serve their parent's flush.
    assert {r.flush for r in recs.values()} == {7}
    assert (recs["a"].start_ns, recs["a"].end_ns) == (0, 70)


def test_records_only_between_mark_and_disable(ticking):
    spans.enable()
    spans.end(spans.begin("before"))
    spans.mark()
    spans.end(spans.begin("during"))
    spans.disable()
    assert _names(spans.records()) == ["during"]
    assert set(spans.totals()) == {"before", "during"}
    spans.reset()
    assert spans.totals() == {} and spans.records() == []


def test_an_end_skipped_by_an_exception_is_closed_by_its_parent(ticking):
    spans.enable()
    spans.mark()
    a = spans.begin("a")
    spans.begin("lost")                     # never ended
    spans.end(a)
    b = spans.begin("b")
    spans.end(b)
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"a", "b"} and recs["b"].parent is None
    # A span opened before a reset is dropped at its end.
    c = spans.begin("c")
    spans.reset()
    spans.end(c)
    assert spans.totals() == {}


def test_off_state_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span site called the recorder while off")
    for fn in ("begin", "end", "begin_tail", "open_flush", "new_flush"):
        monkeypatch.setattr(spans, fn, refuse)
    _replay(scan_ratio=0.1)
    assert spans.totals() == {} and spans.records() == []


def _replay(**kw):
    wl = generate(400, n_key_pages=8, read_ratio=kw.pop("read_ratio", 0.8),
                  alpha=0.9, seed=5, max_scan_len=100, **kw)
    arr = SimChipArray(n_chips=4, pages_per_chip=8, device_seed=2)
    be = make_backend("batched", arr, device="cpu")
    rep = replay(wl, be, RunConfig(burst=32, fused=True))
    return rep, be


@pytest.mark.parametrize("read_ratio,scan_ratio", [(0.95, 0.0), (0.5, 0.0),
                                                   (0.0, 0.95)])
def test_a_replay_is_the_same_with_spans_on(read_ratio, scan_ratio):
    off, be_off = _replay(read_ratio=read_ratio, scan_ratio=scan_ratio)
    spans.enable()
    spans.mark()
    on, be_on = _replay(read_ratio=read_ratio, scan_ratio=scan_ratio)
    spans.disable()
    for f in ("read_values", "read_hits", "scan_counts"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))
    assert dataclasses.asdict(be_on.stats) == dataclasses.asdict(be_off.stats)
    names = set(spans.totals())
    # The bulk load and the replay's own paths, each under its name.
    assert {"backend.program", "chip.program", "chip.ecc", "chip.randomize",
            "backend.flush", "backend.flush.stage", "backend.flush.launch",
            "backend.tail", "planestore.restage", "copy.h2d",
            "copy.d2h"} <= names
    want = {"frontend.scan", "frontend.scan.plan"} if scan_ratio else {
        "frontend.read", "frontend.burst", "frontend.drain",
        "backend.result_wait"}
    if read_ratio == 0.5:
        want.add("frontend.write")
    assert want <= names
    # No kernel launches on the CPU: the plain versions run.
    assert "kernel.launch" not in names
    assert be_on.stats.flushes == spans.totals()["backend.flush"][0]


def test_a_tail_carries_its_flush_id_and_waits_from_its_end():
    arr = SimChipArray(n_chips=2, pages_per_chip=4, device_seed=3)
    be = make_backend("batched", arr, device="cpu")
    keys = np.arange(1, 41, dtype=np.uint64)
    for p in range(4):
        be.program_entries(p, keys + 100 * p)
    spans.enable()
    spans.mark()
    bursts = []
    for p in (0, 1):
        bursts.append([be.submit_lookup(Command.lookup(p, p + 2,
                                                       int(keys[3]) + 100 * p))
                       for _ in range(3)])
        be.flush()
    for tickets in bursts:
        assert [t.result().value_slot for t in tickets] == [11] * 3
    spans.disable()
    recs = spans.records()
    flushes = [r for r in recs if r.name == "backend.flush"]
    tails = [r for r in recs if r.name == "backend.tail"]
    waits = [r for r in recs if r.name == spans.RESULT_WAIT]
    assert len(flushes) == len(tails) == len(waits) == 2
    assert [t.flush for t in tails] == [f.flush for f in flushes] \
        == [w.flush for w in waits]
    assert len({f.flush for f in flushes}) == 2
    for f, t, w in zip(flushes, tails, waits):
        assert w.start_ns == f.end_ns and w.end_ns == t.start_ns
        assert w.end_ns - w.start_ns >= 0
    # The flush's children serve it; the tail's copies serve its flush.
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name in ("backend.flush.stage", "backend.flush.launch"):
            assert by_id[r.parent].name == "backend.flush"
            assert r.flush == by_id[r.parent].flush
        if r.name == "copy.d2h":
            assert by_id[r.parent].name == "backend.tail"
            assert r.flush == by_id[r.parent].flush
    count, total, self_ns = spans.totals()[spans.RESULT_WAIT]
    assert count == 2 and total == self_ns >= 0


def test_each_flush_copies_through_the_layout_helpers():
    """A lookup flush uploads its rows and two operands, a plan flush its
    rows and three operands, a restage its row indices and four planes;
    each tail copies its outputs back: every copy is a span of the two
    helpers (on the card, each is counted in ``COPIES``)."""
    arr = SimChipArray(n_chips=2, pages_per_chip=4, device_seed=3)
    be = make_backend("batched", arr, device="cpu")
    keys = np.arange(1, 41, dtype=np.uint64)
    for p in range(4):
        be.program_entries(p, keys)
    spans.enable()
    spans.mark()
    t = be.submit_lookup(Command.lookup(0, 2, 5))
    be.flush()                              # stages page 0, then 2
    t.result()
    from repro_torch.core.range_query import exact_range
    plan = exact_range(3, 9, width=64)
    t = be.submit_plan(Command.plan(1, plan.include, plan.exclude))
    be.flush()                              # stages page 1
    t.result()
    spans.disable()
    recs = spans.records()
    by_id = {r.id: r for r in recs}

    def under(name):
        out = []
        for r in recs:
            if r.name.startswith("copy."):
                p = by_id.get(r.parent)
                while p is not None and p.name != name:
                    p = by_id.get(p.parent)
                if p is not None:
                    out.append(r.name)
        return out
    tails = [r for r in recs if r.name == "backend.tail"]
    restages = [r for r in recs if r.name == "planestore.restage"]
    assert len(tails) == 2 and len(restages) == 3
    assert under("planestore.restage") == ["copy.h2d"] * 3 * 5
    assert under("backend.flush.stage") == ["copy.h2d"] * (3 * 5 + 3 + 4)
    assert under("backend.tail") == ["copy.d2h"] * (3 + 1)
    assert "copy.h2d" not in under("backend.tail")


# -------------------------------------------------------- copy counter
def test_copies_to_and_from_the_cpu_are_not_counted():
    layout.reset_copies()
    w = np.array([1, 2**32 - 1, 7], np.uint32)
    t = layout.words_to_tensor(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(layout.tensor_to_words(t), w)
    i64 = layout.words_to_tensor([3, 2**40], "cpu", np.int64)
    assert i64.dtype == torch.int64 and i64.tolist() == [3, 2**40]
    i32 = np.array([4, 5], np.int32)
    t32 = layout.words_to_tensor(i32, "cpu", np.int32)
    assert t32.dtype == torch.int32
    i32[0] = 9                              # a copy, never an alias
    assert t32.tolist() == [4, 5]
    assert layout.COPIES == {"h2d": 0, "h2d_bytes": 0, "d2h": 0,
                             "d2h_bytes": 0}


# ------------------------------------------------- reading against a trace
def _rec(i, name, t0, t1, parent=None, flush=None):
    return spans.Record(i, parent, name, t0, t1, flush)


def test_innermost_pieces_and_the_split_of_intervals():
    recs = [_rec(2, "b", 10, 20, 1), _rec(3, "c", 30, 60, 1),
            _rec(4, "d", 40, 50, 3), _rec(1, "a", 0, 70),
            _rec(5, "e", 100, 110),
            _rec(6, spans.RESULT_WAIT, 0, 200)]   # a wait names no piece
    pieces = spans.innermost(recs)
    assert pieces == [(0, 10, "a"), (10, 20, "b"), (20, 30, "a"),
                      (30, 40, "c"), (40, 50, "d"), (50, 60, "c"),
                      (60, 70, "a"), (100, 110, "e")]
    got = spans.split([(5, 15), (45, 105), (120, 130)], pieces)
    assert got == {"a": 5 + 10, "b": 5, "d": 5, "c": 10, "client": 30 + 10,
                   "e": 5}
    assert sum(got.values()) == 10 + 60 + 10


def test_launch_pairs_clock_offset_and_check():
    recs = [_rec(1, "kernel.launch", 100, 120),
            _rec(2, "kernel.launch", 200, 230),
            _rec(3, "copy.h2d", 150, 160)]
    off = 1_000_000
    kernels = [("void (anonymous namespace)::lookup_kernel(int*)",
                off + 260, 8),
               ("at::native::index_copy_kernel", off + 10, 9),
               ("_anonymous_namespace_::plan_kernel", off + 140, 7)]
    pairs = spans.launch_pairs(recs, kernels, ("lookup_kernel",
                                               "plan_kernel"))
    assert [(r.id, k[2]) for r, k in pairs] == [(1, 7), (2, 8)]
    runtime = {7: (off + 105, off + 112), 8: (off + 215, off + 221)}
    mid, width = spans.clock_offset(pairs, runtime)
    # Call 7 bounds the offset to [off - 8, off + 5], call 8 to
    # [off - 9, off + 15].
    assert (mid, width) == (off - 2, 13)
    assert spans.check_launches(pairs, mid) == (0, (42 + 62) / 2)
    # A mapping that puts a launch span after its kernel is caught.
    assert spans.check_launches(pairs, off + 50)[0] == 1
    assert spans.clock_offset(pairs, {}) is None
    assert spans.launch_pairs(recs[:1], kernels, ("lookup_kernel",
                                                  "plan_kernel")) is None


def test_device_drift_maps_the_device_clock_onto_the_host_clock():
    """A device clock 40 us ahead at the first call and gaining 5 ns a
    us: the fit through each run's least lag recovers it, and the mapped
    starts check clean where the raw ones do not."""
    recs, kernels, runtime = [], [], {}
    for i in range(40):
        t = 1_000_000 * i                   # a launch a millisecond
        recs.append(_rec(i + 1, "kernel.launch", t, t + 30_000))
        call = t + 10_000
        lag = 3_000 + (i % 4) * 7_000       # true call -> start lags
        ahead = -40_000 - 5 * (call - 10_000) // 1000
        kernels.append(("lookup_kernel", call + lag + ahead, i))
        runtime[i] = (call, call + 2_000)
    pairs = spans.launch_pairs(recs, kernels, ("lookup_kernel",))
    assert spans.clock_offset(pairs, runtime) == (-4_000, 28_000)
    t0, a, b = spans.device_drift(pairs, runtime)
    assert t0 == 10_000
    assert abs(a - (3_000 - 40_000)) < 1 and abs(b + 0.005) < 1e-9
    assert spans.check_launches(pairs, 0)[0] > 0
    violations, lag = spans.check_launches(pairs, 0, (t0, a, b))
    # Span start to kernel start: 10 us to the call, then 3-24 us.
    assert violations == 0 and lag == pytest.approx(20_500, abs=100)
    assert spans.on_host(kernels[0][1], None) == kernels[0][1]
    assert spans.device_drift(pairs[:1], runtime) is None
