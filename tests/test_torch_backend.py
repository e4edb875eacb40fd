"""The port's batched backend against the JAX package's, bit for bit.

Both backends run on the CPU — the port with ``device="cpu"`` (the plain
PyTorch versions of its kernels), the JAX package with its Pallas kernels
in interpret mode — over identically programmed chip arrays.  Bitmaps,
gathered chunks, lookups and the ``BackendStats`` counters must agree
exactly (tolerance 0).
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.backend import BatchedKernelBackend as JBatched
from repro.core.commands import Command as JCommand
from repro.core.commands import Op as JOp
from repro.core.engine import SimChipArray as JSimChipArray
from repro_torch import resolve_device
from repro_torch.backend import BatchedKernelBackend, PlaneStore, make_backend
from repro_torch.convert import chip_array_from_numpy, chip_array_to_numpy
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.kernels.layout import tensor_to_words

N_PAGES = 12
ENTRIES = 300
STATS = ("searches", "gathers", "lookups", "flushes", "kernel_launches",
         "staged_pages", "staged_queries", "staged_bytes", "batched_searches",
         "programs", "programs_coalesced", "result_bytes")


def _page_keys(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 2**62, ENTRIES, dtype=np.uint64)
            for _ in range(N_PAGES)]


def _pair(page_keys, n_chips=5, per_chip=8, seed=31):
    """(port backend, JAX backend) over identically programmed arrays."""
    port = SimChipArray(n_chips=n_chips, pages_per_chip=per_chip,
                        device_seed=seed)
    ref = JSimChipArray(n_chips=n_chips, pages_per_chip=per_chip,
                        device_seed=seed)
    for p, keys in enumerate(page_keys):
        port.program_entries(p, keys)
        ref.program_entries(p, keys)
    return BatchedKernelBackend(port, device="cpu"), JBatched(ref)


def _same_stats(a, b):
    assert {k: getattr(a.stats, k) for k in STATS} == \
        {k: getattr(b.stats, k) for k in STATS}


def _search_args(page_keys, seed, n=48):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(0, N_PAGES))
        if rng.random() < 0.5:
            q, mask = int(page_keys[p][rng.integers(0, ENTRIES)]), 2**64 - 1
        else:
            q = int(rng.integers(1, 2**62))
            mask = int(rng.integers(0, 2**64, dtype=np.uint64))
        out.append(Command.search(p, q, mask))
    out.append(Command.search(0, 0, 0))                 # match-all
    out.append(out[0])                                  # a duplicate cell
    return out


def _submit_both(port, ref, cmds, kind):
    """Submit the same commands to both backends, flush, return results."""
    tp, tr = [], []
    for c in cmds:
        tp.append(getattr(port, f"submit_{kind}")(c))
        jc = JCommand(JOp(c.op.value), c.page_addr, query=c.query,
                      mask=c.mask, chunk_bitmap=c.chunk_bitmap,
                      value_page=c.value_page)
        tr.append(getattr(ref, f"submit_{kind}")(jc))
    port.flush()
    ref.flush()
    return [t.result() for t in tp], [t.result() for t in tr]


@pytest.fixture(scope="module")
def keys():
    return _page_keys()


def test_search_bitmaps_and_counters_identical(keys):
    port, ref = _pair(keys)
    got, want = _submit_both(port, ref, _search_args(keys, 1), "search")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)
        assert (a.match_count, a.open_verdict) == (b.match_count,
                                                   b.open_verdict)
    _same_stats(port, ref)
    for c, d in zip(port.chips.chips, ref.chips.chips):
        assert vars(c.counters) == vars(d.counters)


def test_gathers_identical(keys):
    port, ref = _pair(keys)
    rng = np.random.default_rng(2)
    cmds = [Command.gather(p, int(rng.integers(0, 2**64, dtype=np.uint64)))
            for p in range(N_PAGES)]
    cmds += [Command.gather(0, 0), Command.gather(1, 2**64 - 1)]
    got, want = _submit_both(port, ref, cmds, "gather")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.chunks, b.chunks)
        np.testing.assert_array_equal(a.chunk_ids, b.chunk_ids)
        np.testing.assert_array_equal(a.parity_ok, b.parity_ok)
        assert a.parity_ok.all()
    _same_stats(port, ref)


def test_lookups_identical_one_launch(keys):
    port, ref = _pair(keys)
    rng = np.random.default_rng(4)
    cmds = []
    for _ in range(24):
        kp = int(rng.integers(0, N_PAGES // 2))
        q = (int(keys[kp][rng.integers(0, ENTRIES)]) if rng.random() < 0.7
             else int(rng.integers(2**62, 2**63)))
        cmds.append(Command.lookup(kp, kp + N_PAGES // 2, q))
    got, want = _submit_both(port, ref, cmds, "lookup")
    assert port.stats.kernel_launches == 1
    hits = 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.search.bitmap_words,
                                      b.search.bitmap_words)
        assert (a.search.match_count, a.value_slot, a.value, a.parity_ok) \
            == (b.search.match_count, b.value_slot, b.value, b.parity_ok)
        hits += a.value_slot is not None
    assert 0 < hits < len(cmds)
    _same_stats(port, ref)


def test_planestore_invalidation_on_reprogram():
    """program -> search -> reprogram -> search reflects the new image on
    both packages, and only the dirty 4 KiB row re-ships."""
    rng = np.random.default_rng(9)
    keys_a = rng.integers(1, 2**62, 100, dtype=np.uint64)
    keys_b = rng.integers(1, 2**62, 100, dtype=np.uint64)
    port, ref = _pair([keys_a] * 6, n_chips=3, per_chip=8, seed=17)
    probe = Command.search(2, int(keys_b[7]))
    got, want = _submit_both(port, ref, [probe], "search")
    assert got[0].match_count == want[0].match_count == 0
    warm = port.stats.staged_bytes
    port.chips.program_entries(2, keys_b)
    ref.chips.program_entries(2, keys_b)
    got, want = _submit_both(port, ref, [probe], "search")
    np.testing.assert_array_equal(got[0].bitmap_words, want[0].bitmap_words)
    assert got[0].match_count == 1
    assert port.stats.staged_bytes - warm == 4096
    warm = port.stats.staged_bytes
    got, _ = _submit_both(port, ref, [Command.search(2, int(keys_a[0]))],
                          "search")
    assert got[0].match_count == 0 and port.stats.staged_bytes == warm
    _same_stats(port, ref)


def test_planestore_zero_restage_after_warmup(keys):
    port, ref = _pair(keys)
    cmds = [Command.search(p, int(keys[p][3])) for p in range(N_PAGES)]
    _submit_both(port, ref, cmds, "search")
    for _ in range(3):
        before = port.stats.staged_bytes
        _submit_both(port, ref, cmds, "search")
        assert port.stats.staged_bytes == before
    _same_stats(port, ref)


def test_lazy_tail_survives_reprogram_between_flush_and_drain(keys):
    """A gather flushed before a reprogram resolves against the flushed
    planes and the flush-time parities, on both packages."""
    port, ref = _pair(keys)
    tp = port.submit_gather(Command.gather(3, 0b110))
    tr = ref.submit_gather(JCommand.gather(3, 0b110))
    port.flush()
    ref.flush()
    new = np.arange(1, 400, dtype=np.uint64)
    port.chips.program_entries(3, new)
    ref.chips.program_entries(3, new)
    a, b = tp.result(), tr.result()
    np.testing.assert_array_equal(a.chunks, b.chunks)
    np.testing.assert_array_equal(a.parity_ok, b.parity_ok)
    assert a.parity_ok.all()


def test_deferred_programs_coalesce_and_stage_once(keys):
    port, ref = _pair(keys)
    _submit_both(port, ref, [Command.search(p, 1) for p in range(4)],
                 "search")
    new = np.arange(5, 305, dtype=np.uint64)
    for be in (port, ref):
        be.submit_program(1, new)
        be.submit_program(1, new + 1)                   # coalesces
        be.submit_program(2, new)
    got, want = _submit_both(port, ref, [Command.search(1, 6)], "search")
    np.testing.assert_array_equal(got[0].bitmap_words, want[0].bitmap_words)
    assert got[0].match_count == 1
    _same_stats(port, ref)


def test_chip_array_carried_across_from_jax():
    """A JAX-programmed array crosses as numpy; searches on it match."""
    keys = _page_keys(seed=21)
    ref_arr = JSimChipArray(n_chips=4, pages_per_chip=4, device_seed=9)
    for p, k in enumerate(keys):
        ref_arr.program_entries(p, k, timestamp_ns=1000 + p)
    ref_arr.chips[1].inject_bit_errors(0, 3, byte_region=(64, 4096))
    port_arr = chip_array_from_numpy(chip_array_to_numpy(ref_arr))
    for c, d in zip(port_arr.chips, ref_arr.chips):
        assert c.device_seed == d.device_seed and c.n_pages == d.n_pages
        assert sorted(c.pages) == sorted(d.pages)
        for a in c.pages:
            sa, sb = c.pages[a], d.pages[a]
            np.testing.assert_array_equal(sa.raw, sb.raw)
            np.testing.assert_array_equal(sa.clean_raw, sb.clean_raw)
            np.testing.assert_array_equal(sa.chunk_parities,
                                          sb.chunk_parities)
            assert (sa.timestamp_ns, sa.n_entries, sa.injected_error_bits) \
                == (sb.timestamp_ns, sb.n_entries, sb.injected_error_bits)
    port, ref = BatchedKernelBackend(port_arr, device="cpu"), JBatched(ref_arr)
    got, want = _submit_both(port, ref, _search_args(keys, 5, n=24),
                             "search")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)
    _same_stats(port, ref)


def test_chip_array_from_numpy_refuses_foreign_seeds():
    state = chip_array_to_numpy(SimChipArray(2, 4, device_seed=3))
    state["chips"][1]["device_seed"] = 99
    with pytest.raises(ValueError):
        chip_array_from_numpy(state)


def test_take_and_take2d_gather_resident_rows(keys):
    port, _ = _pair(keys)
    store = port.store
    rows = store.rows_for([4, 1, 7])
    lo, hi, ids, seeds = store.take(rows, 5)
    assert lo.shape == (5, 512) and ids.shape == (5,)
    torch.testing.assert_close(lo[3], lo[0], rtol=0, atol=0)  # pad: row 0
    lo2, hi2, ids2, seeds2 = store.take2d(np.array([[rows[2], rows[0]]]))
    torch.testing.assert_close(lo2[0, 0], lo[2], rtol=0, atol=0)
    torch.testing.assert_close(seeds2[0, 1], seeds[0], rtol=0, atol=0)
    chip, local = port.chips.route(7)
    assert int(tensor_to_words(ids[2])) == local
    assert int(tensor_to_words(seeds[2])) == chip.device_seed


def _count_store_calls(monkeypatch):
    """Count ``PlaneStore`` row gathers (``take``/``take2d``: one
    ``index_select`` per arena tensor) and index uploads."""
    calls = {"take": 0, "upload": 0}
    select, upload = PlaneStore._select, PlaneStore.upload_rows

    def counted_select(self, ridx):
        calls["take"] += 1
        return select(self, ridx)

    def counted_upload(self, *row_sets, pad_to):
        calls["upload"] += 1
        return upload(self, *row_sets, pad_to=pad_to)
    monkeypatch.setattr(PlaneStore, "_select", counted_select)
    monkeypatch.setattr(PlaneStore, "upload_rows", counted_upload)
    return calls


def test_search_and_lookup_flushes_read_the_arena_in_place(keys,
                                                           monkeypatch):
    """A search, lookup or gather flush copies no rows out of the arena:
    one index upload, one launch, results equal to the JAX package's."""
    calls = _count_store_calls(monkeypatch)
    port, ref = _pair(keys)
    got, want = _submit_both(port, ref, _search_args(keys, 3), "search")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)
    assert calls == {"take": 0, "upload": 1}
    cmds = [Command.lookup(p, N_PAGES - 1 - p, int(keys[p][7]))
            for p in range(N_PAGES)]
    got, want = _submit_both(port, ref, cmds, "lookup")
    for a, b in zip(got, want):
        assert (a.value_slot, a.value, a.parity_ok) == \
            (b.value_slot, b.value, b.parity_ok)
        assert a.value_slot is not None
    assert calls == {"take": 0, "upload": 2}
    got, want = _submit_both(port, ref, [Command.gather(2, 0b101)], "gather")
    np.testing.assert_array_equal(got[0].chunks, want[0].chunks)
    np.testing.assert_array_equal(got[0].chunk_ids, [0, 2])
    assert calls == {"take": 0, "upload": 3}
    assert port.stats.kernel_launches == 3
    _same_stats(port, ref)


def test_gather_flush_reads_the_arena_in_place(monkeypatch):
    """A gather burst over 40 resident pages (rows past the first 32-row
    block, repeated pages, an empty and a full bitmap, padded to 64 rows):
    one upload, one launch, no row copies, and chunks, chunk ids, parity
    and every counter equal to the JAX package's."""
    keys = [np.random.default_rng(p).integers(1, 2**62, 100, dtype=np.uint64)
            for p in range(40)]
    port = SimChipArray(n_chips=5, pages_per_chip=8, device_seed=9)
    ref = JSimChipArray(n_chips=5, pages_per_chip=8, device_seed=9)
    for p, k in enumerate(keys):
        port.program_entries(p, k)
        ref.program_entries(p, k)
    port, ref = BatchedKernelBackend(port, device="cpu"), JBatched(ref)
    _submit_both(port, ref, [Command.search(p, 1) for p in range(40)],
                 "search")                     # all 40 pages resident
    calls = _count_store_calls(monkeypatch)
    rng = np.random.default_rng(5)
    cmds = [Command.gather(p, int(rng.integers(0, 2**64, dtype=np.uint64)))
            for p in range(39, 5, -1)]
    cmds += [Command.gather(37, 0), Command.gather(33, 2**64 - 1),
             Command.gather(33, 1), Command.gather(3, 1 << 63)]
    got, want = _submit_both(port, ref, cmds, "gather")
    assert calls == {"take": 0, "upload": 1}
    assert port.stats.kernel_launches == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.chunks, b.chunks)
        np.testing.assert_array_equal(a.chunk_ids, b.chunk_ids)
        np.testing.assert_array_equal(a.parity_ok, b.parity_ok)
        assert a.parity_ok.all()
    assert len(got[-4].chunk_ids) == 0 and len(got[-3].chunk_ids) == 64
    _same_stats(port, ref)


def test_in_place_reads_past_the_first_arena_block():
    """40 resident pages (the arena grows past its first 32-row block
    between flushes): searches and lookups through rows past 32, repeated
    pages and interleaved key/value pages equal the JAX package's."""
    keys = [np.random.default_rng(p).integers(1, 2**62, 100, dtype=np.uint64)
            for p in range(40)]
    port = SimChipArray(n_chips=5, pages_per_chip=8, device_seed=3)
    ref = JSimChipArray(n_chips=5, pages_per_chip=8, device_seed=3)
    for p, k in enumerate(keys):
        port.program_entries(p, k)
        ref.program_entries(p, k)
    port, ref = BatchedKernelBackend(port, device="cpu"), JBatched(ref)
    for lo_page in (0, 20):
        cmds = [Command.search(p, int(keys[p][p % 100]))
                for p in range(lo_page, lo_page + 20)]
        cmds += [Command.search(37, int(keys[37][1]), 2**32 - 1)] * 2
        got, want = _submit_both(port, ref, cmds, "search")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)
            assert a.match_count >= 1
    cmds = [Command.lookup(p, p + 1 if p % 2 == 0 else p - 1,
                           int(keys[p][5]))
            for p in range(30, 40)] + [Command.lookup(39, 38, 12345)]
    got, want = _submit_both(port, ref, cmds, "lookup")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.search.bitmap_words,
                                      b.search.bitmap_words)
        assert (a.value_slot, a.value, a.parity_ok) == \
            (b.value_slot, b.value, b.parity_ok)
    assert port.store.resident_rows == 40
    _same_stats(port, ref)


def test_upload_rows_pads_checks_and_uploads_once(keys):
    port, _ = _pair(keys)
    store = port.store
    rows = store.rows_for([4, 1, 7])
    k, v = store.upload_rows(rows, rows[::-1], pad_to=6)
    assert k.dtype == torch.int32 and k.shape == v.shape == (6,)
    assert k.is_contiguous() and v.is_contiguous()
    np.testing.assert_array_equal(k.numpy(), list(rows) + [0, 0, 0])
    np.testing.assert_array_equal(v.numpy(), list(rows[::-1]) + [0, 0, 0])
    assert v.data_ptr() % 16 == 0 and k.untyped_storage().data_ptr() == \
        v.untyped_storage().data_ptr()               # one upload
    with pytest.raises(IndexError):
        store.upload_rows([store.resident_rows], pad_to=4)
    with pytest.raises(IndexError):
        store.upload_rows([-1], pad_to=4)
    with pytest.raises(ValueError):
        store.upload_rows(rows, pad_to=2)
    lo, hi, ids, seeds = store.arena()
    assert lo.shape == (store._cap, 512) and ids.shape == (store._cap,)


# ------------------------------------------------------------ device guards

def test_no_device_means_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chips = SimChipArray(2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedKernelBackend(chips)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("batched", chips)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlaneStore(chips, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_plan_path_queues_and_resolves():
    """Range plans are ported: a plan queues, flushes as one ``sim_plan``
    launch and resolves to one combined bitmap a page."""
    be = make_backend("batched", SimChipArray(2, 4), device="cpu")
    be.program_entries(1, np.arange(10, 20, dtype=np.uint64))
    t = be.submit_plan(Command.plan(1, [(12, 2**64 - 2)], [(13, 2**64 - 1)]))
    assert be.pending == 1
    be.flush()
    assert be.stats.plans == be.stats.kernel_launches == 1
    # 12 and 13 share the prefix; 13 is excluded: only slot 8 + 2 is left.
    assert t.result().match_count == 1
    assert (int(t.result().bitmap_words[0]) >> 10) & 1


# The name is from before slice 7, when this path raised; it is kept so
# the test's ID stays stable across the port's slices.
@pytest.mark.parametrize("name", ["sharded"])
def test_unported_backends_raise_not_implemented(name):
    """The sharded backend is ported with its device-fault tier: it builds
    from the factory, and ``enable_device_faults`` attaches a
    ``DeviceFaultState`` — a dead chip's search fails over to its replica
    and runs through a launch over the replica's row, equal to the JAX
    backend's host read of the replica."""
    from repro.backend import make_backend as jmake_backend
    from repro.reliability import DeviceFaultState as JDeviceFaultState
    from repro.reliability import FaultSchedule as JFaultSchedule
    from repro_torch.reliability import DeviceFaultState, FaultSchedule

    port = make_backend(name, SimChipArray(2, 8), device="cpu", replicas=2)
    ref = jmake_backend(name, JSimChipArray(2, 8), use_kernel=False,
                        replicas=2)
    for be in (port, ref):
        be.program_entries(1, np.arange(10, 20, dtype=np.uint64))
    assert port.search(Command.search(1, 12)).match_count == 1
    assert port.stats.kernel_launches == 1
    state = DeviceFaultState(FaultSchedule.dead_chip(chip=1))
    port.enable_device_faults(state)
    ref.enable_device_faults(JDeviceFaultState(JFaultSchedule.dead_chip(
        chip=1)))
    assert port.faults is state
    got = port.search(Command.search(1, 12))
    want = ref.search(JCommand.search(1, 12))
    np.testing.assert_array_equal(got.bitmap_words, want.bitmap_words)
    assert got.open_verdict == want.open_verdict
    assert got.match_count == 1 and port.stats.kernel_launches == 2
    assert vars(state.stats) == vars(ref.faults.stats)
    assert state.stats.failovers == state.stats.degraded_ops == 1


# The name is from before slice 7, when this path raised; it is kept so
# the test's ID stays stable across the port's slices.
def test_unported_paths_raise_not_implemented():
    """The reliability tier is ported: ``enable_reliability`` attaches a
    ``ReliabilityState``, and searches over a page with header damage
    below the outer-code budget fall back, repair and equal the JAX
    batched backend's (bitmaps, verdicts, stats).  An unknown backend
    name still raises."""
    from repro.reliability import ReliabilityState as JReliabilityState
    from repro_torch.reliability import ReliabilityState

    keys = _page_keys()
    port, ref = _pair(keys)
    for be in (port, ref):
        be.chips.chips[0].inject_bit_errors(
            0, 12, rng=np.random.default_rng(4), byte_region=(0, 64))
    rel, jrel = ReliabilityState(), JReliabilityState()
    port.enable_reliability(rel)
    ref.enable_reliability(jrel)
    assert port.reliability is rel
    for p in (0, 5, 0):
        cmd = Command.search(p, int(keys[p][3]))
        got = port.search(cmd)
        want = ref.search(JCommand.search(p, int(keys[p][3])))
        np.testing.assert_array_equal(got.bitmap_words, want.bitmap_words)
        assert (got.match_count, got.open_verdict) \
            == (want.match_count, want.open_verdict)
        assert got.match_count >= 1
    assert vars(rel.stats) == vars(jrel.stats) and rel.stats.fallbacks == 1
    _same_stats(port, ref)
    with pytest.raises(ValueError):
        make_backend("nonesuch", SimChipArray(2, 4), device="cpu")
