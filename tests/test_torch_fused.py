"""The port's cross-product ``sim_fused`` and the quickstart against the JAX
package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
bit-exact (tolerance 0) against the Pallas ``_fused_kernel`` run in
interpret mode, over the JAX package's own sweeps
(tests/test_kernels.py) plus the header chunk and overflow past
``max_out``.  Inputs come from numpy seeds and cross as numpy.  The CUDA
kernel is held against the plain version on the card in
tests/test_torch_gpu.py.
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core.bits import unpack_bitmap
from repro.core.page import build_page
from repro.kernels.layout import pages_to_planes
from repro.kernels.sim_fused.ops import sim_fused as jax_fused
from repro.kernels.sim_fused.ops import sim_fused_pages as jax_fused_pages
from repro.kernels.sim_search.ops import sim_search_pages as jax_search_pages
from repro_torch import quickstart
from repro_torch.kernels.layout import (pages_to_chunk_words,
                                        tensor_to_words, words_to_tensor)
from repro_torch.kernels.sim_fused.ops import sim_fused, sim_fused_pages
from repro_torch.kernels.sim_search.ops import sim_search_pages

FULL = 0xFFFFFFFFFFFFFFFF


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return words_to_tensor(a, "cpu")


def _same(got, want):
    bm, out, cnt = got
    np.testing.assert_array_equal(tensor_to_words(bm), np.asarray(want[0]))
    np.testing.assert_array_equal(tensor_to_words(out), np.asarray(want[1]))
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n_pages", [2, 17])
def test_sim_fused_single_query_matches_pallas(n_pages):
    rng = np.random.default_rng(n_pages + 50)
    lo, hi = _u32(rng, (n_pages, 512)), _u32(rng, (n_pages, 512))
    q = np.array([lo[0, 10], hi[0, 10]], dtype=np.uint32)
    m = np.array([0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32)
    want = jax_fused(lo, hi, q, m, max_out=8, page_block=8)
    got = sim_fused(_t(lo), _t(hi), _t(q), _t(m), max_out=8)
    assert got[0].shape == (n_pages, 16) and got[2].shape == (n_pages,)
    _same(got, want)
    assert int(got[2][0]) == 1


@pytest.mark.parametrize("n_pages,n_queries", [(2, 1), (17, 3), (8, 4)])
def test_sim_fused_multiquery_matches_pallas(n_pages, n_queries):
    """Q queries x N pages with per-page flash addresses and seeds, the
    stream regenerated; then the last query is loosened to a 4-bit mask
    that selects more chunks than ``max_out`` keeps."""
    rng = np.random.default_rng(n_pages * 3 + n_queries)
    lo, hi = _u32(rng, (n_pages, 512)), _u32(rng, (n_pages, 512))
    q = _u32(rng, (n_queries, 2))
    m = np.full((n_queries, 2), 0xFFFFFFFF, dtype=np.uint32)
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = rng.integers(0, 2**31, n_pages).astype(np.uint32)
    want = jax_fused(lo, hi, q, m, max_out=4, page_block=8, randomized=True,
                     page_ids=ids, page_seeds=seeds)
    got = sim_fused(_t(lo), _t(hi), _t(q), _t(m), max_out=4, randomized=True,
                    page_ids=_t(ids), page_seeds=_t(seeds))
    _same(got, want)

    # a loose mask, so the comparison is not of empty maps
    stream_q = np.asarray(jax_fused(lo, hi, np.zeros(2, np.uint32),
                                    np.zeros(2, np.uint32), max_out=1,
                                    randomized=True, page_ids=ids,
                                    page_seeds=seeds)[2])
    assert (stream_q == 64).all()             # mask 0 matches every slot
    m[-1] = [0xF, 0]
    want = jax_fused(lo, hi, q, m, max_out=4, page_block=8, randomized=True,
                     page_ids=ids, page_seeds=seeds)
    got = sim_fused(_t(lo), _t(hi), _t(q), _t(m), max_out=4, randomized=True,
                    page_ids=_t(ids), page_seeds=_t(seeds))
    _same(got, want)
    assert (got[2][-1] > 4).all()             # overflow past max_out


def test_header_chunk_is_gathered_and_overflow_counted():
    """Unlike the paired lookup, the cross product selects the header chunk
    (slots 0..7); counts include chunks dropped past ``max_out``."""
    rng = np.random.default_rng(7)
    lo, hi = _u32(rng, (3, 512)), _u32(rng, (3, 512))
    q = np.array([[lo[0, 3], hi[0, 3]], [0, 0]], dtype=np.uint32)
    m = np.array([[0xFFFFFFFF] * 2, [0, 0]], dtype=np.uint32)
    for max_out in (2, 16, 64):
        want = jax_fused(lo, hi, q, m, max_out=max_out, page_block=8)
        got = sim_fused(_t(lo), _t(hi), _t(q), _t(m), max_out=max_out)
        _same(got, want)
    bm, out, cnt = (tensor_to_words(t) for t in got)
    cw = np.stack([lo.reshape(3, 64, 8), hi.reshape(3, 64, 8)],
                  axis=-1).reshape(3, 64, 16)
    assert cnt[0].tolist() == [1, 0, 0] and (bm[0, 0, 0] >> 3) & 1
    np.testing.assert_array_equal(out[0, 0, 0], cw[0, 0])    # header chunk
    assert (cnt[1] == 64).all()
    np.testing.assert_array_equal(out[1], cw)
    got2 = sim_fused(_t(lo), _t(hi), _t(q), _t(m), max_out=2)
    assert (got2[2][1] == 64).all()
    np.testing.assert_array_equal(tensor_to_words(got2[1])[1], cw[:, :2])


def test_sim_fused_gathers_matching_chunk():
    keys = np.arange(100, 604, dtype=np.uint64)
    pages = np.stack([build_page(keys, p, randomize=False).plain
                      for p in range(3)])
    got = sim_fused_pages(pages, 307, FULL, max_out=2, device="cpu")
    _same(got, jax_fused_pages(pages, 307, FULL, max_out=2))
    slot = 8 + (307 - 100)
    bits = unpack_bitmap(tensor_to_words(got[0])[0], xp=np)
    assert (np.nonzero(bits[0])[0] == [slot]).all()
    np.testing.assert_array_equal(tensor_to_words(got[1])[0, 0, 0],
                                  pages_to_chunk_words(pages)[0, slot // 8])
    assert got[2].tolist() == [[1, 1, 1]]


@pytest.mark.parametrize("randomized", [False, True])
def test_pages_helpers_match_pallas(randomized):
    keys = np.arange(5_000, 5_504, dtype=np.uint64)
    pages = np.stack([build_page(keys + 504 * p, p, device_seed=9,
                                 randomize=randomized).raw
                      for p in range(5)])
    probes = [5_000 + 504 * 2 + 17, 5_000 + 3, 1]
    kw = dict(randomized=randomized, device_seed=9)
    got = sim_search_pages(pages, probes, [FULL] * 3, device="cpu", **kw)
    want = np.asarray(jax_search_pages(pages, probes, [FULL] * 3, **kw))
    np.testing.assert_array_equal(tensor_to_words(got), want)
    assert want[:2].any() and not want[2].any()
    _same(sim_fused_pages(pages, probes, [FULL] * 3, max_out=3,
                          device="cpu", **kw),
          jax_fused_pages(pages, probes, [FULL] * 3, max_out=3, **kw))


def test_quickstart_matches_the_jax_quickstart(capsys):
    """The port's quickstart on the CPU returns the arrays the JAX
    quickstart (examples/quickstart.py) computes for steps 2–5."""
    out = quickstart.main(device="cpu")
    assert "hit (page, slot) = [(1, 127)]" in capsys.readouterr().out
    assert (out["slot"], out["key"], out["hits"]) == (131, 10_123, [(1, 127)])
    keys = np.arange(10_000, 10_504, dtype=np.uint64)
    pages = np.stack([build_page(keys + 504 * p, p, device_seed=7).raw
                      for p in range(4)])
    want = np.asarray(jax_search_pages(pages, [10_623], [FULL],
                                       randomized=True, device_seed=7))
    np.testing.assert_array_equal(out["search"], want)
    lo, hi = pages_to_planes(pages)
    q = np.array([10_623 & 0xFFFFFFFF, 0], np.uint32)
    m = np.array([0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    want = jax_fused(lo, hi, q, m, max_out=4, randomized=True, device_seed=7)
    for a, b in zip(out["fused"], want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert out["fused"][2].tolist() == [0, 1, 0, 0]


def test_sim_fused_refuses_other_devices():
    meta = torch.empty((2, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sim_fused(meta, meta, meta[0, :2], meta[0, :2])
