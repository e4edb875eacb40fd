"""The port's §V indexes against the JAX package's, at the sizes of
``tests/test_indexes.py``.

``SimBTree``, ``SimHashIndex`` and ``SimSecondaryIndex`` run on the port's
scalar backend and on its batched backend with ``device="cpu"`` (the plain
PyTorch versions of the kernels), each against the same index on the JAX
package's backend of the same name (its batched one runs Pallas in
interpret mode); ``BaselineBTree`` runs against the JAX package's.  Results,
``LookupStats``, splits, directory depth, the split counters, I/O bytes,
``BackendStats`` and the per-chip counters must agree exactly.  On the
batched backend every index call also makes its exact number of launches.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.backend import make_backend as jmake_backend
from repro.core.bitweaving import Column as JColumn
from repro.core.bitweaving import RowCodec as JRowCodec
from repro.core.engine import SimChipArray as JSimChipArray
from repro.index.baseline import BaselineBTree as JBaselineBTree
from repro.index.btree import SimBTree as JSimBTree
from repro.index.hashindex import SimHashIndex as JSimHashIndex
from repro.index.hashindex import _hash64 as j_hash64
from repro.index.secondary import SimSecondaryIndex as JSimSecondaryIndex
from repro_torch.backend import BackendStats, make_backend
from repro_torch.core.bitweaving import Column, RowCodec
from repro_torch.core.engine import SimChipArray
from repro_torch.core.page import USER_SLOTS
from repro_torch.index.baseline import BaselineBTree
from repro_torch.index.btree import SimBTree
from repro_torch.index.hashindex import (BUCKET_CAPACITY, DEPTH_CAP,
                                         SimHashIndex, _hash64)
from repro_torch.index.secondary import SimSecondaryIndex

STATS = [f.name for f in dataclasses.fields(BackendStats)]
BACKENDS = ["scalar", "batched"]


def _pair(name, n_chips, per_chip):
    """(port backend, JAX backend) of one name over fresh chip arrays."""
    kw = {"device": "cpu"} if name == "batched" else {}
    return (make_backend(name, SimChipArray(n_chips=n_chips,
                                            pages_per_chip=per_chip), **kw),
            jmake_backend(name, JSimChipArray(n_chips=n_chips,
                                              pages_per_chip=per_chip)))


def _same_backends(port, ref):
    assert {k: getattr(port.stats, k) for k in STATS} == \
        {k: getattr(ref.stats, k) for k in STATS}
    for c, d in zip(port.chips.chips, ref.chips.chips):
        assert vars(c.counters) == vars(d.counters)


def _launches(be):
    return be.stats.kernel_launches


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(42)
    keys = (rng.choice(10**9, size=3000, replace=False) + 1).astype(np.uint64)
    return keys, keys * np.uint64(13)


# ---------------------------------------------------------------- B+Tree

@pytest.mark.parametrize("name", BACKENDS)
def test_btree_identical_to_jax(dataset, name):
    keys, values = dataset
    be, jbe = _pair(name, 8, 64)
    bt, jbt = SimBTree(be), JSimBTree(jbe)
    bt.bulk_load(keys, values)
    jbt.bulk_load(keys, values)
    present = set(keys.tolist())
    misses = [int(k) + 1 for k in keys[:30] if int(k) + 1 not in present]
    probes = [int(k) for k in keys[::100]] + misses + [int(keys.min()) - 1]

    before = _launches(be)
    got = bt.lookup_batch(probes)
    assert _launches(be) - before == (name == "batched")
    assert got == jbt.lookup_batch(probes)
    assert got[:len(keys[::100])] == [int(k) * 13 for k in keys[::100]]
    assert all(v is None for v in got[len(keys[::100]):])
    assert dataclasses.asdict(bt.stats) == dataclasses.asdict(jbt.stats)

    # A burst of keys all below the first separator submits nothing.
    before = _launches(be)
    assert bt.lookup_batch([0, 1]) == [None, None]
    assert _launches(be) == before

    for q_lo, q_hi in ((40, 43), (0, 1), (99.5, 100)):
        lo, hi = (int(np.percentile(keys, q_lo)),
                  int(np.percentile(keys, q_hi)))
        before = _launches(be)
        rows = bt.range_query(lo, hi)
        assert rows == jbt.range_query(lo, hi)
        assert sorted(rows) == sorted((int(k), int(k) * 13) for k in keys
                                      if lo <= k < hi)
        if name == "batched":          # one sim_plan, one sim_gather on a hit
            assert _launches(be) - before == 1 + bool(rows)
    # Below the first separator: no leaf, no launch.  Between two keys of
    # one leaf: one plan launch and no gather.
    sk = np.sort(keys)
    i = int(np.nonzero(np.diff(sk) > 2)[0][5])
    for (lo, hi), launches in (((2, 3), 0),
                               ((int(sk[i]) + 1, int(sk[i + 1])), 1)):
        before = _launches(be)
        assert bt.range_query(lo, hi) == jbt.range_query(lo, hi) == []
        assert _launches(be) - before == launches * (name == "batched")
    assert dataclasses.asdict(bt.stats) == dataclasses.asdict(jbt.stats)
    _same_backends(be, jbe)


def test_baseline_btree_identical_to_jax(dataset):
    keys, values = dataset
    bb = BaselineBTree(SimChipArray(n_chips=8, pages_per_chip=64))
    jbb = JBaselineBTree(JSimChipArray(n_chips=8, pages_per_chip=64))
    bb.bulk_load(keys, values)
    jbb.bulk_load(keys, values)
    for k in list(keys[::100]) + [int(keys[0]) + 1, 0]:
        assert bb.lookup(int(k)) == jbb.lookup(int(k))
    lo, hi = int(np.percentile(keys, 40)), int(np.percentile(keys, 43))
    assert bb.range_query(lo, hi) == jbb.range_query(lo, hi)
    assert (bb.pages_read, bb.bytes_read) == (jbb.pages_read, jbb.bytes_read)
    assert bb.leaves == jbb.leaves


@pytest.mark.parametrize("name", BACKENDS)
def test_btree_point_io_is_two_orders_lower(dataset, name):
    keys, values = dataset
    be, _ = _pair(name, 8, 64)
    bt = SimBTree(be)
    bt.bulk_load(keys, values)
    bb = BaselineBTree(SimChipArray(n_chips=8, pages_per_chip=64))
    bb.bulk_load(keys, values)
    assert bt.lookup_batch([int(k) for k in keys[:64]]) == \
        [bb.lookup(int(k)) for k in keys[:64]]
    assert (bt.stats.bitmap_bytes + bt.stats.chunk_bytes) * 50 < bb.bytes_read


# ------------------------------------------------------------ hash index

def _hash_both(be, jbe, keys, **kw):
    h, jh = SimHashIndex(be, **kw), JSimHashIndex(jbe, **kw)
    for k in keys:
        h.insert(int(k), int(k) % 99991)
        jh.insert(int(k), int(k) % 99991)
    return h, jh


def _same_hash(h, jh):
    assert (h.splits, h.global_depth, h.split_searches,
            h.split_gathered_chunks, h.directory, h._next_page) == \
        (jh.splits, jh.global_depth, jh.split_searches,
         jh.split_gathered_chunks, jh.directory, jh._next_page)
    assert dataclasses.asdict(h.write_buffer.stats) == \
        dataclasses.asdict(jh.write_buffer.stats)
    for b, jb in zip(h.buckets, jh.buckets, strict=True):
        assert (b.key_page, b.value_page, b.local_depth) == \
            (jb.key_page, jb.value_page, jb.local_depth)
        np.testing.assert_array_equal(b.keys, jb.keys)
        np.testing.assert_array_equal(b.values, jb.values)
    _same_backends(h.backend, jh.backend)


@pytest.mark.parametrize("name", BACKENDS)
def test_hash_index_crud_and_splits_identical_to_jax(name):
    rng = np.random.default_rng(3)
    keys = (rng.choice(10**9, size=2500, replace=False) + 1).astype(np.uint64)
    be, jbe = _pair(name, 8, 512)
    h, jh = _hash_both(be, jbe, keys)
    assert h.splits > 0 and h.split_searches == h.splits
    probes = [int(k) for k in keys[::37]] + [10**12 + 7]
    h.flush_writes()
    jh.flush_writes()
    before = _launches(be)
    got = h.lookup_batch(probes)
    assert _launches(be) - before == 2 * (name == "batched")
    assert got == jh.lookup_batch(probes)
    assert got == [int(k) % 99991 for k in keys[::37]] + [None]
    before = _launches(be)
    assert h.lookup_batch([10**12 + 7]) == [None]   # no hit: no gather
    assert jh.lookup_batch([10**12 + 7]) == [None]
    assert _launches(be) - before == (name == "batched")
    for x in (h, jh):                 # overwrite
        x.insert(int(keys[0]), 777)
    assert h.lookup(int(keys[0])) == jh.lookup(int(keys[0])) == 777
    _same_hash(h, jh)


@pytest.mark.parametrize("name", BACKENDS)
def test_hash_split_after_buffered_inserts(name):
    """A split reads the bucket's key page on the device right after
    buffered inserts: the buffer drains (one grouped reprogram) before the
    split's search, and each split is one search and one gather launch."""
    rng = np.random.default_rng(5)
    keys = (rng.choice(10**9, size=BUCKET_CAPACITY * 4 + 1,
                       replace=False) + 1).astype(np.uint64)
    be, jbe = _pair(name, 4, 256)
    h, jh = SimHashIndex(be, global_depth=0, write_high_water=10**6), \
        JSimHashIndex(jbe, global_depth=0, write_high_water=10**6)
    for x in (h, jh):
        for k in keys[:BUCKET_CAPACITY]:
            x.insert(int(k), int(k) % 1013)
    assert h.splits == 0 and h.write_buffer.n_dirty == 2
    before = _launches(be)
    for x in (h, jh):                 # the bucket is full: this one splits
        x.insert(int(keys[BUCKET_CAPACITY]), 1)
    assert h.splits == 1
    assert _launches(be) - before == 2 * (name == "batched")
    assert h.split_gathered_chunks == jh.split_gathered_chunks > 0
    for x in (h, jh):
        for k in keys[BUCKET_CAPACITY + 1:]:
            x.insert(int(k), int(k) % 1013)
    probes = [int(k) for k in keys[:BUCKET_CAPACITY:7]]
    assert h.lookup_batch(probes) == jh.lookup_batch(probes) == \
        [k % 1013 for k in probes]
    _same_hash(h, jh)


_M64 = (1 << 64) - 1


def _inv_shift_xor(z: int, r: int) -> int:
    """Invert y = z ^ (z >> r) for 64-bit z."""
    y = z
    for _ in range(64 // r + 1):
        y = z ^ (y >> r)
    return y & _M64


def _unhash64(h: int) -> int:
    """Exact inverse of hashindex._hash64 (splitmix64 is a bijection)."""
    inv1 = pow(0x94D049BB133111EB, -1, 1 << 64)
    inv2 = pow(0xBF58476D1CE4E5B9, -1, 1 << 64)
    z = _inv_shift_xor(h, 31)
    z = (z * inv1) & _M64
    z = _inv_shift_xor(z, 27)
    z = (z * inv2) & _M64
    z = _inv_shift_xor(z, 30)
    return (z - 0x9E3779B97F4A7C15) & _M64


def test_hash64_equal_jax_and_unhash_inverts_it():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**64, 256, dtype=np.uint64)
    np.testing.assert_array_equal(_hash64(keys), j_hash64(keys))
    hs = rng.integers(1, 2**63, 64, dtype=np.uint64)
    back = np.array([_unhash64(int(h)) for h in hs], dtype=np.uint64)
    np.testing.assert_array_equal(_hash64(back), hs)
    assert DEPTH_CAP == 20 and BUCKET_CAPACITY == 404


@pytest.mark.parametrize("name", BACKENDS)
def test_hash_adversarial_keys_identical_to_jax(name):
    """Every key shares the low hash bits up to the depth cap: splits run
    to the cap and the bucket overflows in place, in both packages."""
    depth_cap = 8
    n = BUCKET_CAPACITY + 6
    keys = [_unhash64((i << depth_cap) | 0x5A) for i in range(1, n + 1)]
    be, jbe = _pair(name, 4, 2048)
    h = SimHashIndex(be, depth_cap=depth_cap)
    jh = JSimHashIndex(jbe, depth_cap=depth_cap)
    for i, k in enumerate(keys):
        h.insert(int(k), i + 1)
        jh.insert(int(k), i + 1)
    target = h.buckets[h.directory[h._dir_slot(keys[0])]]
    assert target.local_depth == depth_cap and target.n == n
    probes = [int(k) for k in keys[::29]]
    assert h.lookup_batch(probes) == jh.lookup_batch(probes) == \
        [keys.index(k) + 1 for k in probes]
    _same_hash(h, jh)


@pytest.mark.parametrize("name", BACKENDS)
def test_hash_overflow_past_page_raises_like_jax(name):
    depth_cap = 4
    keys = [_unhash64((i << depth_cap) | 0x3)
            for i in range(1, USER_SLOTS + 2)]
    be, jbe = _pair(name, 2, 256)
    h = SimHashIndex(be, depth_cap=depth_cap)
    jh = JSimHashIndex(jbe, depth_cap=depth_cap)
    for x in (h, jh):
        with pytest.raises(RuntimeError, match="depth cap"):
            for i, k in enumerate(keys):
                x.insert(int(k), i + 1)
        x.insert(int(keys[0]), 4242)   # an update still fits
    assert h.lookup(int(keys[0])) == jh.lookup(int(keys[0])) == 4242
    _same_hash(h, jh)


@pytest.mark.parametrize("name", BACKENDS)
def test_hash_inserts_coalesce_programs_like_jax(name):
    rng = np.random.default_rng(9)
    keys = (rng.choice(10**9, size=600, replace=False) + 1).astype(np.uint64)
    be, jbe = _pair(name, 4, 512)
    h = SimHashIndex(be, write_high_water=16)
    jh = JSimHashIndex(jbe, write_high_water=16)
    for x in (h, jh):
        for k in keys[:300]:
            x.insert(int(k), int(k) % 1097)
    assert h.lookup(int(keys[0])) == jh.lookup(int(keys[0])) == \
        int(keys[0]) % 1097
    for x in (h, jh):
        for k in keys[300:]:
            x.insert(int(k), int(k) % 1097)
        x.flush_writes()
    programs = sum(c.counters.programs for c in h.chips.chips)
    assert programs < 2 * len(keys) / 4 + 2 * len(h.buckets)
    assert h.write_buffer.stats.coalesced > 0
    probes = [int(k) for k in keys[::43]]
    assert h.lookup_batch(probes) == jh.lookup_batch(probes) == \
        [k % 1097 for k in probes]
    _same_hash(h, jh)


# -------------------------------------------------------- secondary index

@pytest.mark.parametrize("name", BACKENDS)
def test_secondary_index_identical_to_jax(name):
    rng = np.random.default_rng(4)
    cols = [("gender", 1), ("age", 7), ("salary", 20), ("uid", 32)]
    codec = RowCodec([Column(*c) for c in cols])
    be, jbe = _pair(name, 4, 64)
    si = SimSecondaryIndex(be, codec)
    jsi = JSimSecondaryIndex(jbe, JRowCodec([JColumn(*c) for c in cols]))
    n = 3000
    rows = {"gender": rng.integers(0, 2, n), "age": rng.integers(0, 128, n),
            "salary": rng.integers(0, 10_000, n), "uid": np.arange(n)}
    si.load_rows(rows)
    jsi.load_rows(rows)

    before = _launches(be)
    fem = si.select_equals("gender", 1)
    assert _launches(be) - before == 2 * (name == "batched")
    np.testing.assert_array_equal(fem, jsi.select_equals("gender", 1))
    assert sorted(codec.decode_rows(fem, "uid").tolist()) == \
        sorted(np.nonzero(rows["gender"] == 1)[0].tolist())

    want = set(np.nonzero((rows["salary"] >= 2001)
                          & (rows["salary"] < 7000))[0].tolist())
    for exact in (True, False):
        before = _launches(be)
        got = si.select_range("salary", 2001, 7000, exact=exact)
        assert _launches(be) - before == 2 * (name == "batched")
        np.testing.assert_array_equal(
            got, jsi.select_range("salary", 2001, 7000, exact=exact))
        assert set(codec.decode_rows(got, "uid").tolist()) == want
    # A predicate no row meets: one plan launch, no gather.
    before = _launches(be)
    assert si.select_range("salary", 10_000, 10_005).size == 0
    assert jsi.select_range("salary", 10_000, 10_005).size == 0
    assert _launches(be) - before == (name == "batched")
    assert (si.io_bitmap_bytes, si.io_chunk_bytes, si.n_pages) == \
        (jsi.io_bitmap_bytes, jsi.io_chunk_bytes, jsi.n_pages)
    _same_backends(be, jbe)


@pytest.mark.parametrize("name", BACKENDS)
def test_secondary_index_strips_vacant_slots(name):
    """Vacant slots (all-ones) alias an all-set column test; rows are
    stripped by the page's row count, as in the JAX package."""
    cols = [("flag", 1), ("rest", 63)]
    codec = RowCodec([Column(*c) for c in cols])
    be, jbe = _pair(name, 2, 8)
    si = SimSecondaryIndex(be, codec)
    jsi = JSimSecondaryIndex(jbe, JRowCodec([JColumn(*c) for c in cols]))
    rows = {"flag": np.ones(10, np.int64), "rest": np.arange(10)}
    si.load_rows(rows)
    jsi.load_rows(rows)
    got = si.select_equals("flag", 1)
    np.testing.assert_array_equal(got, jsi.select_equals("flag", 1))
    assert got.size == 10
    _same_backends(be, jbe)
