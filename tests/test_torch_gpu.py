"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips itself when no CUDA device is
present (decided inside the test, never at import).  On the card, run them
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerance is 0: the kernels and the plain versions compute the same
integer function.
"""
import numpy as np
import pytest
import torch

from repro_torch.backend import make_backend
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.range_query import (RangePlan, approximate_range,
                                          exact_range)
from repro_torch.frontend import RunConfig, replay
from repro_torch.kernels import native
from repro_torch.kernels.layout import words_to_tensor
from repro_torch.kernels.sim_fused.ops import sim_fused_lookup
from repro_torch.kernels.sim_fused.ref import sim_lookup_ref
from repro_torch.kernels.sim_gather.ops import sim_gather
from repro_torch.kernels.sim_gather.ref import sim_gather_ref
from repro_torch.kernels.sim_plan.ops import sim_plan
from repro_torch.kernels.sim_plan.ref import plan_pass_rows, sim_plan_ref
from repro_torch.kernels.sim_search.ops import sim_search
from repro_torch.kernels.sim_search.ref import sim_search_ref, stream_planes
from repro_torch.workload.ycsb import generate


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda", torch.cuda.current_device())


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _check_equal(kernel_out, plain_out):
    for k, p in zip(kernel_out, plain_out):
        assert torch.equal(k.cpu(), p.cpu())


def _stream(ids, seeds):
    """The §IV-C1 stream planes of the plain version, as numpy uint32."""
    s_lo, s_hi = stream_planes(words_to_tensor(ids, "cpu"),
                               words_to_tensor(seeds, "cpu"))
    return s_lo.numpy().astype(np.uint32), s_hi.numpy().astype(np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pages,n_queries", [(64, 64), (70, 5), (1, 1)])
def test_sim_search_kernel_matches_plain(n_pages, n_queries):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_pages * 3 + n_queries)
    lo, hi = _u32(rng, (n_pages, 512)), _u32(rng, (n_pages, 512))
    q, m = _u32(rng, (n_queries, 2)), _u32(rng, (n_queries, 2))
    m[1::2] = [0xF, 0]                         # ~1 slot in 16 matches
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = _u32(rng, (n_pages,))
    p, s = n_pages - 1, 7
    for randomized in (False, True):
        # Plant query 0 on (page p, slot s) in the domain the kernel matches.
        s_lo, s_hi = _stream(ids, seeds) if randomized else (0, 0)
        q[0] = [lo[p, s] ^ (s_lo[p, s] if randomized else 0),
                hi[p, s] ^ (s_hi[p, s] if randomized else 0)]
        m[0] = [0xFFFFFFFF, 0xFFFFFFFF]
        args = [words_to_tensor(a, dev) for a in (lo, hi, q, m, ids, seeds)]
        before = native.LAUNCHES["sim_search"]
        got = sim_search(*args, randomized=randomized)
        torch.cuda.synchronize()
        assert native.LAUNCHES["sim_search"] == before + 1
        plain = sim_search_ref(*args, randomized=randomized)
        assert (int(plain[0, p, s // 32]) >> (s % 32)) & 1
        _check_equal([got], [plain])


@pytest.mark.gpu
@pytest.mark.parametrize("n_pages,max_out", [(64, 64), (64, 4), (33, 80)])
def test_sim_gather_kernel_matches_plain(n_pages, max_out):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_pages + max_out)
    chunks = words_to_tensor(_u32(rng, (n_pages, 64, 16)), dev)
    bm = words_to_tensor(_u32(rng, (n_pages, 2)), dev)
    got = sim_gather(chunks, bm, max_out=max_out)
    torch.cuda.synchronize()
    _check_equal(got, sim_gather_ref(chunks, bm, max_out))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [64, 13, 1])
def test_sim_lookup_kernel_matches_plain(n_rows):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_rows)
    klo, khi, vlo, vhi = (_u32(rng, (n_rows, 512)) for _ in range(4))
    ids = rng.integers(0, 4096, n_rows).astype(np.uint32)
    seeds = _u32(rng, (n_rows,))
    m = np.full((n_rows, 2), 0xFFFFFFFF, np.uint32)
    for randomized in (False, True):
        # Even rows: user slot s and header slot 3 hold the same key, so
        # the first user slot s wins; odd rows: header slot 3 alone, a miss.
        s_lo, s_hi = _stream(ids, seeds) if randomized else (
            np.zeros_like(klo), np.zeros_like(khi))
        q = _u32(rng, (n_rows, 2))
        want = np.full(n_rows, 512)
        for i in range(n_rows):
            s = int(rng.integers(8, 512)) if i % 2 == 0 else 3
            q[i] = [klo[i, s] ^ s_lo[i, s], khi[i, s] ^ s_hi[i, s]]
            klo[i, 3], khi[i, 3] = q[i, 0] ^ s_lo[i, 3], q[i, 1] ^ s_hi[i, 3]
            if i % 2 == 0:
                want[i] = s
        args = [words_to_tensor(a, dev) for a in (
            klo, khi, vlo, vhi, q, m, ids, seeds)]
        got = sim_fused_lookup(*args, randomized=randomized)
        torch.cuda.synchronize()
        plain = sim_lookup_ref(*args, randomized=randomized)
        np.testing.assert_array_equal(plain[2].cpu().numpy(), want)
        _check_equal(got, plain)


def _plan_groups(keys, rng, p_pad):
    """Four plan groups over the (N, 512) 64-bit domain keys: an exact
    range (as wide as ``p_pad`` passes allow) holding page 0's slots
    100..163, with an exclude block on slot 102; a group of exclude passes
    only; an approximate range; and an all-PAD group."""
    base = int(rng.integers(2**41, 2**47))
    keys[0, 100:164] = base + np.arange(64, dtype=np.uint64)
    exc = exact_range(base + 2, base + 3)
    wide = (base - int(rng.integers(2**39, 2**40)),
            base + int(rng.integers(2**39, 2**40)))
    for lo, hi in [wide, (base + 1, base + 49), (base + 1, base + 13),
                   (base + 1, base + 4)]:
        inc = exact_range(lo, hi)
        if inc.n_passes + exc.n_passes <= p_pad:
            break
    return [RangePlan(inc.include, exc.include),
            RangePlan((), exact_range(base, base + 4).include),
            approximate_range(base, base + 40), RangePlan(())]


@pytest.mark.gpu
@pytest.mark.parametrize("n_pages,p_pad", [(32, 16), (64, 128), (70, 8),
                                           (1, 4)])
def test_sim_plan_kernel_matches_plain(n_pages, p_pad):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_pages * 7 + p_pad)
    keys = rng.integers(1, 2**48, (n_pages, 512), dtype=np.uint64)
    plans = _plan_groups(keys, rng, p_pad)
    q = np.zeros((len(plans), p_pad, 2), np.uint32)
    m, f = np.zeros_like(q), np.zeros((len(plans), p_pad), np.uint32)
    for g, plan in enumerate(plans):
        cmd = Command.plan(0, plan.include, plan.exclude)
        q[g], m[g], f[g] = plan_pass_rows(cmd.plan_include,
                                          cmd.plan_exclude, p_pad)
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = _u32(rng, (n_pages,))
    want = np.stack([plan.evaluate(keys) for plan in plans])
    assert want[0, 0, 101] and not want[0, 0, 102]  # include, exclude
    for randomized in (False, True):
        s_lo, s_hi = _stream(ids, seeds) if randomized else (0, 0)
        lo = (keys & 0xFFFFFFFF).astype(np.uint32) ^ s_lo
        hi = (keys >> np.uint64(32)).astype(np.uint32) ^ s_hi
        args = [words_to_tensor(a, dev) for a in (lo, hi, q, m, f, ids,
                                                  seeds)]
        before = native.LAUNCHES["sim_plan"]
        got = sim_plan(*args, randomized=randomized)
        torch.cuda.synchronize()
        assert native.LAUNCHES["sim_plan"] == before + 1
        plain = sim_plan_ref(*args, randomized=randomized)
        bits = np.unpackbits(plain.cpu().numpy().view(np.uint8),
                             axis=-1, bitorder="little").astype(bool)
        np.testing.assert_array_equal(bits, want)
        _check_equal([got], [plain])


@pytest.mark.gpu
def test_scan_replay_on_card_matches_cpu():
    _cuda_or_skip()
    wl = generate(300, n_key_pages=8, read_ratio=0.5, alpha=0.9, seed=5,
                  scan_ratio=0.3, max_scan_len=100)
    reports, plans = {}, {}
    for device in (None, "cpu"):               # None: the card
        arr = SimChipArray(n_chips=4, pages_per_chip=8, device_seed=2)
        before = native.LAUNCHES["sim_plan"]
        reports[device] = replay(wl, make_backend("batched", arr,
                                                  device=device),
                                 RunConfig(burst=32, fused=True))
        plans[device] = native.LAUNCHES["sim_plan"] - before
    card, cpu = reports[None], reports["cpu"]
    assert card.n_scans == int((wl.ops == 2).sum()) > 0
    assert plans == {None: card.n_scans, "cpu": 0}
    np.testing.assert_array_equal(card.scan_counts, cpu.scan_counts)
    np.testing.assert_array_equal(card.read_values, cpu.read_values)
    assert (card.kernel_launches, card.staged_bytes, card.result_bytes) == \
        (cpu.kernel_launches, cpu.staged_bytes, cpu.result_bytes)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_replay_on_card_matches_cpu(fused):
    _cuda_or_skip()
    wl = generate(400, n_key_pages=8, read_ratio=0.9, alpha=0.9, seed=5)
    reports = {}
    for device in (None, "cpu"):               # None: the card
        arr = SimChipArray(n_chips=4, pages_per_chip=8, device_seed=2)
        reports[device] = replay(wl, make_backend("batched", arr,
                                                  device=device),
                                 RunConfig(burst=32, fused=fused))
    card, cpu = reports[None], reports["cpu"]
    np.testing.assert_array_equal(card.read_values, cpu.read_values)
    np.testing.assert_array_equal(card.read_hits, cpu.read_hits)
    assert card.read_hits[wl.ops == 0].all()
    assert (card.kernel_launches, card.staged_bytes, card.result_bytes) == \
        (cpu.kernel_launches, cpu.staged_bytes, cpu.result_bytes)
