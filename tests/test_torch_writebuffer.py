"""The port's §VI DRAM write buffer against the JAX package's.

``WriteBuffer`` semantics — last-wins coalescing, the read-your-writes
overlay, the high-water trip, one deferred program group per drain — and
the buffered replay, split and fused, which must equal the JAX package's
buffered replay on the same workload (values, hits and every counter) and
the port's own eager replay (values and hits).
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import make_backend as jmake_backend
from repro.buffer.writebuffer import WriteBuffer as JWriteBuffer
from repro.core.engine import SimChipArray as JSimChipArray
from repro.frontend import RunConfig as JRunConfig
from repro.frontend import replay as jreplay
from repro.workload.ycsb import generate as jgenerate
from repro_torch.backend import make_backend
from repro_torch.buffer import WriteBuffer, WriteBufferStats
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.frontend import RunConfig, replay
from repro_torch.workload.ycsb import generate

COUNTERS = ("reads", "writes", "scans", "flushes", "kernel_launches",
            "staged_bytes", "result_bytes", "programs", "write_flushes",
            "buffer_read_hits")


def _backend(n_chips=2, per_chip=8, seed=0):
    return make_backend("batched", SimChipArray(n_chips, per_chip, seed),
                        device="cpu")


# ------------------------------------------------------------- unit semantics

def test_writebuffer_coalesces_and_overlays():
    wb = WriteBuffer(high_water=4)
    a = np.arange(1, 11, dtype=np.uint64)
    b = a * np.uint64(3)
    wb.put(7, a)
    src = a.copy()
    a[:] = 0                              # callers may mutate their mirror
    np.testing.assert_array_equal(wb.get(7), src)
    wb.put(7, b)                          # coalesce: last image wins
    np.testing.assert_array_equal(wb.get(7), b)
    assert wb.get(8) is None              # clean pages served by the device
    assert wb.stats.writes == 2 and wb.stats.coalesced == 1
    assert wb.stats.read_hits == 2
    assert wb.n_dirty == 1 and not wb.should_flush
    wb.put(8, b)
    wb.put(9, b)
    wb.put(10, b)
    assert wb.should_flush and wb.stats.max_dirty == 4
    assert wb.dirty_pages == [7, 8, 9, 10]


def test_writebuffer_flush_is_one_program_group():
    be = _backend()
    wb = WriteBuffer(high_water=8)
    img = np.arange(1, 101, dtype=np.uint64)
    for _ in range(5):                    # five writes, one page
        wb.put(3, img)
    wb.put(4, img * np.uint64(2))
    assert wb.flush(be) == 2              # two dirty pages -> two programs
    assert be.stats.programs == 2
    assert wb.n_dirty == 0 and wb.stats.flushes == 1
    assert wb.flush(be) == 0              # empty flush is free
    assert be.search(Command.search(3, int(img[6]))).match_count == 1
    assert be.search(Command.search(4, int(img[6]) * 2)).match_count == 1


def test_high_water_validation():
    with pytest.raises(ValueError):
        WriteBuffer(high_water=0)


@pytest.mark.parametrize("high_water", [1, 2, 3])
def test_would_trip_is_the_pre_image_of_should_flush(high_water):
    """Same answers as the JAX package's buffer on the same put sequence."""
    wb, ref = WriteBuffer(high_water=high_water), \
        JWriteBuffer(high_water=high_water)
    img = np.arange(4, dtype=np.uint64)
    for page in (5, 5, 6, 5, 7, 8):
        assert wb.would_trip(page) == ref.would_trip(page)
        trip = wb.would_trip(page)
        wb.put(page, img)
        ref.put(page, img)
        assert wb.should_flush == trip == ref.should_flush
    assert vars(wb.stats) == vars(ref.stats)


def test_flush_raises_on_unresolved_program_tickets():
    """flush() verifies every buffered page program resolved in THIS
    backend flush; a backend that defers one breaks read-your-writes once
    the overlay is clean."""

    class _StuckTicket:
        done = False

    class _DeferringBackend:
        def submit_program(self, page_addr, entries, **kw):
            return _StuckTicket()

        def flush(self):
            pass        # leaves the ticket unresolved

    buf = WriteBuffer(high_water=4)
    buf.put(3, np.arange(8, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="unresolved"):
        buf.flush(_DeferringBackend())
    # the dirty set drained before the check: no double-program on retry
    assert buf.n_dirty == 0


def test_flush_counts_resolved_programs():
    backend = _backend(n_chips=2, per_chip=16, seed=5)
    buf = WriteBuffer(high_water=4)
    buf.put(0, np.arange(8, dtype=np.uint64))
    buf.put(1, np.arange(8, 16, dtype=np.uint64))
    assert buf.flush(backend) == 2
    assert buf.stats.programs == 2 and buf.stats.flushes == 1
    assert vars(buf.stats) == vars(WriteBufferStats(
        writes=2, programs=2, flushes=1, max_dirty=2))


# ----------------------------------------------------------- buffered replay

@pytest.fixture(scope="module")
def ycsb_a():
    kw = dict(n_key_pages=6, read_ratio=0.5, alpha=0.9, seed=13)
    wl, ref = generate(300, **kw), jgenerate(300, **kw)
    for f in ("ops", "keys", "key_pages", "value_pages"):
        np.testing.assert_array_equal(getattr(wl, f), getattr(ref, f))
    return wl, ref


def _replay_both(wl, jwl, **cfg):
    got = replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                  device="cpu"), RunConfig(**cfg))
    want = jreplay(jwl, jmake_backend("batched", JSimChipArray(4, 16, 3)),
                   JRunConfig(**cfg))
    return got, want


@pytest.mark.parametrize("high_water", [4, 16])
@pytest.mark.parametrize("fused", [False, True])
def test_buffered_replay_identical_to_jax(ycsb_a, fused, high_water):
    wl, jwl = ycsb_a
    got, want = _replay_both(wl, jwl, burst=32, fused=fused,
                             write_buffer=True, write_high_water=high_water)
    np.testing.assert_array_equal(got.read_values, want.read_values)
    np.testing.assert_array_equal(got.read_hits, want.read_hits)
    assert {c: getattr(got.counters, c) for c in COUNTERS} == \
        {c: getattr(want.counters, c) for c in COUNTERS}
    assert got.read_hits[wl.ops == 0].all()
    assert got.buffer_read_hits > 0 and got.write_flushes > 0
    assert got.programs < got.n_writes            # hot pages coalesced
    if fused:
        assert got.kernel_launches == got.flushes
    # The buffer changes when pages reach flash, never what a read returns.
    eager = replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                    device="cpu"),
                   RunConfig(burst=32, fused=fused))
    np.testing.assert_array_equal(got.read_values, eager.read_values)
    assert eager.programs == eager.n_writes and eager.write_flushes == 0


def test_buffered_replay_with_scans_identical_to_jax():
    kw = dict(n_key_pages=4, read_ratio=0.5, alpha=0.5, seed=9,
              scan_ratio=0.2, max_scan_len=30)
    wl, jwl = generate(200, **kw), jgenerate(200, **kw)
    got, want = _replay_both(wl, jwl, burst=16, fused=True,
                             write_buffer=True, write_high_water=3)
    np.testing.assert_array_equal(got.read_values, want.read_values)
    np.testing.assert_array_equal(got.scan_counts, want.scan_counts)
    assert {c: getattr(got.counters, c) for c in COUNTERS} == \
        {c: getattr(want.counters, c) for c in COUNTERS}
    assert got.n_scans > 0 and got.write_flushes > 0


def test_run_config_takes_a_write_buffer_instance(ycsb_a):
    wl, _ = ycsb_a
    wb = WriteBuffer(high_water=5)
    rep = replay(wl, make_backend("batched", SimChipArray(4, 16, 3),
                                  device="cpu"),
                 RunConfig(burst=32, write_buffer=wb))
    assert wb.stats.flushes == rep.write_flushes > 0
    assert wb.stats.read_hits == rep.buffer_read_hits
    assert wb.stats.programs == rep.programs and wb.n_dirty == 0
    with pytest.raises(ValueError, match="WriteBuffer"):
        RunConfig(write_buffer="yes")
