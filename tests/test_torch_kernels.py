"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held bit-exact (tolerance 0) against the Pallas kernels run in interpret
mode, over the JAX package's own shape sweeps (tests/test_kernels.py).
Inputs come from numpy seeds and cross between the packages as numpy.

The CUDA kernels themselves are held against the plain versions on the
card in tests/test_torch_gpu.py.
"""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sim_fused.ops import sim_fused_lookup as jax_lookup
from repro.kernels.sim_gather.ops import sim_gather as jax_gather
from repro.kernels.sim_search.ops import sim_search as jax_search
from repro_torch.kernels import native
from repro_torch.kernels.layout import (chunk_words_to_planes,
                                        pages_to_chunk_words,
                                        planes_to_chunk_words,
                                        tensor_to_words, words_to_tensor)
from repro_torch.kernels.mamba_scan.ops import mamba_conv, mamba_scan
from repro_torch.kernels.sim_fused.ops import sim_fused, sim_fused_lookup
from repro_torch.kernels.sim_gather.ops import sim_gather
from repro_torch.kernels.sim_plan.ops import sim_plan
from repro_torch.kernels.sim_search.ops import sim_search
from repro_torch.kernels.sim_search.ref import stream_planes

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


def test_chunk_words_to_planes_inverts_planes_to_chunk_words():
    rng = np.random.default_rng(2)
    chunks = _t(_u32(rng, (3, 64, 16)))
    lo, hi = chunk_words_to_planes(chunks)
    assert lo.shape == hi.shape == (3, 512)
    assert lo.is_contiguous() and hi.is_contiguous()
    assert torch.equal(planes_to_chunk_words(lo, hi), chunks)
    # Chunk j's word 2s is slot 8j + s's lo word, word 2s + 1 its hi word.
    assert int(lo[1, 8 * 5 + 3]) == int(chunks[1, 5, 6])
    assert int(hi[1, 8 * 5 + 3]) == int(chunks[1, 5, 7])


def _gather(chunks, bm, max_out, **kw):
    """The port's gather on planes made from (N, 64, 16) chunk words."""
    return sim_gather(*chunk_words_to_planes(_t(chunks)), _t(bm),
                      max_out=max_out, **kw)


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
    out, cnt = _gather(chunks, bm, max_out)
    np.testing.assert_array_equal(tensor_to_words(out), np.asarray(want_out))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_sim_gather_order_zero_tail_and_overflow_count():
    chunks = np.arange(64 * 16, dtype=np.uint32).reshape(1, 64, 16)
    chunks[0, 40] = 0xFFFFFFFF
    bm = np.array([[1 << 3, (1 << 8) | (1 << 31)]], np.uint32)
    out, cnt = _gather(chunks, bm, 8)
    out = tensor_to_words(out)
    assert int(cnt[0]) == 3
    np.testing.assert_array_equal(out[0, :3], chunks[0, [3, 40, 63]])
    assert (out[0, 3:] == 0).all()
    out, cnt = _gather(chunks, bm, 2)
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
    sim_gather(_t(lo), _t(hi), _t(np.ones((3, 2), np.uint32)), max_out=4)
    sim_gather(_t(lo), _t(hi), _t(np.ones((2, 2), np.uint32)), max_out=4,
               rows=_t(np.array([2, 0], np.int32)))
    sim_plan(_t(lo), _t(hi), _t(q[None]), _t(m[None]),
             _t(np.ones((1, 2), np.uint32)), _t(ids), _t(seeds),
             randomized=True)
    sim_fused(_t(lo), _t(hi), _t(q), _t(m), max_out=4, randomized=True)
    xz = torch.ones((1, 3, 8))
    u, _ = mamba_conv(xz, torch.zeros((1, 3, 4)), torch.ones((4, 4)))
    mamba_scan(xz, u, torch.ones((1, 3, 9)), torch.zeros((4, 4)),
               torch.ones(4), torch.zeros((1, 4, 4)))
    assert native.LAUNCHES == {"sim_search": 0, "sim_gather": 0,
                               "sim_lookup": 0, "sim_plan": 0,
                               "sim_fused": 0, "flash_attention": 0,
                               "mamba_conv": 0, "mamba_scan": 0}


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sim_search(meta, meta, meta, meta, meta, meta, randomized=True)


# ------------------------------------------------ in place: arena row indices
# Index sets into an arena of ARENA rows: a repeated row, pad rows repeating
# row 0 (as ``PlaneStore`` pads), rows past the first 32.
ARENA = 80
ROW_SETS = {
    "repeats": [5, 5, 7, 5, 40, 7],
    "pad_rows": [3, 9, 21, 0, 0, 0, 0, 0],
    "past_32": [33, 50, 79, 64, 35, 41, 32],
}


def _stream_words(ids, seeds):
    """The §IV-C1 stream planes of the plain version, as numpy uint32."""
    s_lo, s_hi = stream_planes(_t(ids), _t(seeds))
    return s_lo.numpy().astype(np.uint32), s_hi.numpy().astype(np.uint32)


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("n_queries", [1, 5])
@pytest.mark.parametrize("kind", sorted(ROW_SETS))
def test_sim_search_rows_match_pallas_on_gathered_planes(kind, n_queries,
                                                         randomized):
    lo, hi, q, m, ids, seeds = _search_inputs(ARENA, n_queries,
                                              len(kind) + n_queries)
    rows = np.asarray(ROW_SETS[kind], np.int32)
    # Plant query 0 on slot 99 of the launch's second page, in the domain
    # the kernel matches in.
    r = rows[1]
    s_lo, s_hi = _stream_words(ids, seeds) if randomized else (
        np.zeros_like(lo), np.zeros_like(hi))
    q[0] = [lo[r, 99] ^ s_lo[r, 99], hi[r, 99] ^ s_hi[r, 99]]
    take = lambda a: np.asarray(jnp.take(jnp.asarray(a), rows, axis=0))
    want = np.asarray(jax_search(take(lo), take(hi), q, m, page_block=16,
                                 randomized=randomized, page_ids=take(ids),
                                 page_seeds=take(seeds)))
    got = sim_search(_t(lo), _t(hi), _t(q), _t(m), _t(ids), _t(seeds),
                     randomized=randomized, rows=_t(rows))
    assert got.shape == (n_queries, len(rows), 16)
    np.testing.assert_array_equal(tensor_to_words(got), want)
    assert (int(want[0, 1, 99 // 32]) >> (99 % 32)) & 1


@pytest.mark.parametrize("randomized", [False, True])
def test_sim_search_rows_none_is_every_row(randomized):
    lo, hi, q, m, ids, seeds = _search_inputs(37, 5, 3)
    args = [_t(a) for a in (lo, hi, q, m, ids, seeds)]
    want = np.asarray(jax_search(lo, hi, q, m, page_block=16,
                                 randomized=randomized, page_ids=ids,
                                 page_seeds=seeds))
    every = sim_search(*args, randomized=randomized,
                       rows=_t(np.arange(37, dtype=np.int32)))
    np.testing.assert_array_equal(
        tensor_to_words(sim_search(*args, randomized=randomized)), want)
    np.testing.assert_array_equal(tensor_to_words(every), want)


LOOKUP_ROW_SETS = {
    "repeats": ([4, 4, 9, 4, 30, 9], [50, 50, 50, 8, 61, 8]),
    "pad_rows": ([3, 17, 22, 0, 0, 0, 0, 0], [11, 12, 13, 0, 0, 0, 0, 0]),
    "past_32": ([33, 70, 79, 40, 64], [35, 78, 32, 41, 65]),
    "interleaved": ([10, 11, 12, 13, 14, 15], [11, 10, 13, 12, 15, 14]),
}


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("kind", sorted(LOOKUP_ROW_SETS))
def test_sim_lookup_rows_match_pallas_on_gathered_planes(kind, randomized):
    rng = np.random.default_rng(len(kind))
    lo, hi = _u32(rng, (ARENA, 512)), _u32(rng, (ARENA, 512))
    ids = rng.integers(0, 4096, ARENA).astype(np.uint32)
    seeds = _u32(rng, (ARENA,))
    key_rows, value_rows = (np.asarray(r, np.int32)
                            for r in LOOKUP_ROW_SETS[kind])
    s_lo, s_hi = _stream_words(ids, seeds) if randomized else (
        np.zeros_like(lo), np.zeros_like(hi))
    # Row i of the burst by i % 3: 0 — a user slot hit; 1 — a header slot
    # (3) hit only, a miss; 2 — a random query, a miss.  Pad rows (key
    # row 0) take all-ones masks and zero queries, as the backend pads.
    b = len(key_rows)
    q, m = _u32(rng, (b, 2)), np.full((b, 2), 0xFFFFFFFF, np.uint32)
    for i, r in enumerate(key_rows):
        if r == 0:
            q[i] = 0
        elif i % 3 != 2:
            s = int(rng.integers(8, 512)) if i % 3 == 0 else 3
            q[i] = [lo[r, s] ^ s_lo[r, s], hi[r, s] ^ s_hi[r, s]]
    take = lambda a, rows: np.asarray(jnp.take(jnp.asarray(a), rows, axis=0))
    want = jax_lookup(take(lo, key_rows), take(hi, key_rows),
                      take(lo, value_rows), take(hi, value_rows), q, m,
                      row_block=4, randomized=randomized,
                      key_ids=take(ids, key_rows),
                      key_seeds=take(seeds, key_rows))
    got = sim_fused_lookup(*(_t(a) for a in (lo, hi, lo, hi, q, m, ids,
                                             seeds)),
                           randomized=randomized, key_rows=_t(key_rows),
                           value_rows=_t(value_rows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tensor_to_words(g),
                                      np.asarray(w).view(np.uint32))
    slots = got[2].numpy()
    assert (slots[(np.arange(b) % 3 == 0) & (key_rows != 0)] < 512).all()
    assert (slots[np.arange(b) % 3 != 0] == 512).all()
    assert (slots[key_rows == 0] == 512).all()


def test_sim_lookup_rows_none_is_every_row():
    klo, khi, vlo, vhi, q, m, ids, seeds = _lookup_inputs(13, 5)
    want = jax_lookup(klo, khi, vlo, vhi, q, m, row_block=4, randomized=False,
                      key_ids=ids, key_seeds=seeds)
    args = [_t(a) for a in (klo, khi, vlo, vhi, q, m, ids, seeds)]
    every = _t(np.arange(13, dtype=np.int32))
    for got in (sim_fused_lookup(*args, randomized=False),
                sim_fused_lookup(*args, randomized=False, key_rows=every,
                                 value_rows=every)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(tensor_to_words(g),
                                          np.asarray(w).view(np.uint32))


# Index sets into the arena for the in-place gather: repeated rows, pad rows
# repeating row 0 with bitmap 0 (as the gather flush pads), rows past 32.
GATHER_ROW_KINDS = ("repeats", "pad_rows", "past_32")


def _gather_rows(kind, n_pages, rng):
    if kind == "past_32":
        return rng.integers(32, ARENA, n_pages).astype(np.int32)
    rows = rng.integers(1, ARENA, n_pages).astype(np.int32)
    if kind == "repeats" and n_pages > 1:
        rows[1::2] = rows[0]
    if kind == "pad_rows" and n_pages > 1:
        rows[-(n_pages // 2):] = 0
    return rows


@pytest.mark.parametrize("kind", GATHER_ROW_KINDS)
@pytest.mark.parametrize("max_out", [4, 16, 64])
@pytest.mark.parametrize("n_pages", [1, 16, 33])
def test_sim_gather_rows_match_pallas_on_gathered_planes(n_pages, max_out,
                                                         kind):
    """The gather through arena rows equals the Pallas kernel run on chunk
    words built from the same rows, bit for bit."""
    rng = np.random.default_rng(n_pages * 13 + max_out + len(kind))
    lo, hi = _u32(rng, (ARENA, 512)), _u32(rng, (ARENA, 512))
    rows = _gather_rows(kind, n_pages, rng)
    bm = _u32(rng, (n_pages, 2))
    bm[0] = [0xFFFFFFFF, 0xFFFFFFFF]           # overflows every max_out < 64
    if n_pages > 2:
        bm[1] = [1, 0]                         # the header chunk alone
        bm[2] = [0, 1 << 31]                   # the last chunk alone
    bm[rows == 0] = 0                          # pad rows select nothing
    take = lambda a: np.asarray(jnp.take(jnp.asarray(a), rows, axis=0))
    chunks = np.stack([take(lo).reshape(n_pages, 64, 8),
                       take(hi).reshape(n_pages, 64, 8)],
                      axis=-1).reshape(n_pages, 64, 16)
    want_out, want_cnt = jax_gather(chunks, bm, max_out=max_out, page_block=8)
    out, cnt = sim_gather(_t(lo), _t(hi), _t(bm), max_out=max_out,
                          rows=_t(rows))
    assert out.shape == (n_pages, max_out, 16) and cnt.shape == (n_pages,)
    np.testing.assert_array_equal(tensor_to_words(out), np.asarray(want_out))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert int(cnt[0]) == 64
    assert (tensor_to_words(out)[rows == 0] == 0).all()


def test_sim_gather_rows_none_is_every_row():
    rng = np.random.default_rng(4)
    lo, hi = _u32(rng, (37, 512)), _u32(rng, (37, 512))
    bm = _u32(rng, (37, 2))
    args = [_t(a) for a in (lo, hi, bm)]
    every = sim_gather(*args, max_out=16,
                       rows=_t(np.arange(37, dtype=np.int32)))
    plain = sim_gather(*args, max_out=16)
    want_out, want_cnt = jax_gather(tensor_to_words(
        planes_to_chunk_words(args[0], args[1])), bm, max_out=16,
        page_block=8)
    for got in (every, plain):
        np.testing.assert_array_equal(tensor_to_words(got[0]),
                                      np.asarray(want_out))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_cnt))
