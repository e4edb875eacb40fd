"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held bit-exact (tolerance 0) against the Pallas kernels run in interpret
mode, over the JAX package's own shape sweeps (tests/test_kernels.py).
Inputs come from numpy seeds and cross between the packages as numpy.

The CUDA kernels themselves are held against the plain versions on the
card in tests/test_torch_gpu.py.
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.kernels.sim_fused.ops import sim_fused_lookup as jax_lookup
from repro.kernels.sim_gather.ops import sim_gather as jax_gather
from repro.kernels.sim_search.ops import sim_search as jax_search
from repro_torch.kernels import native
from repro_torch.kernels.layout import (pages_to_chunk_words,
                                        planes_to_chunk_words,
                                        tensor_to_words, words_to_tensor)
from repro_torch.kernels.sim_fused.ops import sim_fused_lookup
from repro_torch.kernels.sim_gather.ops import sim_gather
from repro_torch.kernels.sim_plan.ops import sim_plan
from repro_torch.kernels.sim_search.ops import sim_search

CPU = torch.device("cpu")


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a, device=CPU):
    return words_to_tensor(a, device)


def _search_inputs(n_pages, n_queries, seed):
    rng = np.random.default_rng(seed)
    lo, hi = _u32(rng, (n_pages, 512)), _u32(rng, (n_pages, 512))
    q, m = _u32(rng, (n_queries, 2)), _u32(rng, (n_queries, 2))
    # plant a full-mask hit on the first query so some bits are set
    q[0] = [lo[0, 99], hi[0, 99]]
    m[0] = [0xFFFFFFFF, 0xFFFFFFFF]
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = _u32(rng, (n_pages,))
    return lo, hi, q, m, ids, seeds


def _lookup_inputs(n_rows, seed):
    rng = np.random.default_rng(seed)
    klo, khi = _u32(rng, (n_rows, 512)), _u32(rng, (n_rows, 512))
    vlo, vhi = _u32(rng, (n_rows, 512)), _u32(rng, (n_rows, 512))
    q = _u32(rng, (n_rows, 2))
    for i in range(0, n_rows, 2):               # half planted hits
        s = int(rng.integers(8, 512))
        q[i] = [klo[i, s], khi[i, s]]
    q[1 % n_rows] = [klo[1 % n_rows, 3], khi[1 % n_rows, 3]]  # header alias
    m = np.full((n_rows, 2), 0xFFFFFFFF, dtype=np.uint32)
    ids = rng.integers(0, 4096, n_rows).astype(np.uint32)
    seeds = _u32(rng, (n_rows,))
    return klo, khi, vlo, vhi, q, m, ids, seeds


# ----------------------------------------------------------------- layout

def test_planes_to_chunk_words_matches_page_bytes():
    rng = np.random.default_rng(1)
    pages = rng.integers(0, 256, size=(5, 4096)).astype(np.uint8)
    words = pages.view("<u4").reshape(5, 512, 2)
    cw = planes_to_chunk_words(_t(words[..., 0].copy()),
                               _t(words[..., 1].copy()))
    np.testing.assert_array_equal(tensor_to_words(cw),
                                  pages_to_chunk_words(pages))


def test_word_carrier_round_trips_extreme_words():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(tensor_to_words(_t(a)), a)


# ------------------------------------------------------------- sim_search

@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("n_queries", [1, 5])
@pytest.mark.parametrize("n_pages", [1, 3, 32, 70])
def test_sim_search_matches_pallas(n_pages, n_queries, randomized):
    lo, hi, q, m, ids, seeds = _search_inputs(n_pages, n_queries,
                                              n_pages * 10 + n_queries)
    want = np.asarray(jax_search(lo, hi, q, m, page_block=16,
                                 randomized=randomized, page_ids=ids,
                                 page_seeds=seeds))
    got = sim_search(_t(lo), _t(hi), _t(q), _t(m), _t(ids), _t(seeds),
                     randomized=randomized)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(tensor_to_words(got), want)
    assert want.shape == (n_queries, n_pages, 16)


# ------------------------------------------------------------- sim_gather

@pytest.mark.parametrize("max_out", [4, 16, 64])
@pytest.mark.parametrize("n_pages", [1, 16, 33])
def test_sim_gather_matches_pallas(n_pages, max_out):
    rng = np.random.default_rng(n_pages * 7 + max_out)
    chunks = _u32(rng, (n_pages, 64, 16))
    bm = _u32(rng, (n_pages, 2))
    bm[0] = [0xFFFFFFFF, 0xFFFFFFFF]           # overflows every max_out < 64
    want_out, want_cnt = jax_gather(chunks, bm, max_out=max_out, page_block=8)
    out, cnt = sim_gather(_t(chunks), _t(bm), max_out=max_out)
    np.testing.assert_array_equal(tensor_to_words(out), np.asarray(want_out))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_sim_gather_order_zero_tail_and_overflow_count():
    chunks = np.arange(64 * 16, dtype=np.uint32).reshape(1, 64, 16)
    chunks[0, 40] = 0xFFFFFFFF
    bm = np.array([[1 << 3, (1 << 8) | (1 << 31)]], np.uint32)
    out, cnt = sim_gather(_t(chunks), _t(bm), max_out=8)
    out = tensor_to_words(out)
    assert int(cnt[0]) == 3
    np.testing.assert_array_equal(out[0, :3], chunks[0, [3, 40, 63]])
    assert (out[0, 3:] == 0).all()
    out, cnt = sim_gather(_t(chunks), _t(bm), max_out=2)
    assert int(cnt[0]) == 3 and out.shape == (1, 2, 16)


# ------------------------------------------------------------- sim_lookup

@pytest.mark.parametrize("n_rows,row_block", [(3, 4), (8, 8), (13, 4)])
def test_sim_lookup_matches_pallas(n_rows, row_block):
    klo, khi, vlo, vhi, q, m, ids, seeds = _lookup_inputs(
        n_rows, n_rows * 11 + row_block)
    for randomized in (False, True):
        want = jax_lookup(klo, khi, vlo, vhi, q, m, row_block=row_block,
                          randomized=randomized, key_ids=ids, key_seeds=seeds)
        got = sim_fused_lookup(*(_t(a) for a in (klo, khi, vlo, vhi, q, m,
                                                 ids, seeds)),
                               randomized=randomized)
        np.testing.assert_array_equal(tensor_to_words(got[0]),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(tensor_to_words(got[1]),
                                      np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_cpu_tensors_never_launch():
    native.reset_launches()
    lo, hi, q, m, ids, seeds = _search_inputs(3, 2, 0)
    sim_search(_t(lo), _t(hi), _t(q), _t(m), _t(ids), _t(seeds),
               randomized=True)
    sim_gather(_t(np.zeros((2, 64, 16), np.uint32)),
               _t(np.ones((2, 2), np.uint32)), max_out=4)
    sim_plan(_t(lo), _t(hi), _t(q[None]), _t(m[None]),
             _t(np.ones((1, 2), np.uint32)), _t(ids), _t(seeds),
             randomized=True)
    assert native.LAUNCHES == {"sim_search": 0, "sim_gather": 0,
                               "sim_lookup": 0, "sim_plan": 0}


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sim_search(meta, meta, meta, meta, meta, meta, randomized=True)
