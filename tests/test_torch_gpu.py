"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips itself when no CUDA device is
present (decided inside the test, never at import).  On the card, run them
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
Tolerance is 0 for the SiM kernels: they and their plain versions compute
the same integer function.  Flash attention is held at 2e-6 (float32) and
2e-2 (bfloat16), the JAX package's own tolerances: the kernel sums in
another order than the plain version.
"""
import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import database_index, spans
import repro_torch.backend.batched as batched_mod
import repro_torch.backend.sharded as sharded_mod
from repro_torch.analysis.conservation import run_conservation
from repro_torch.analysis.launch_audit import audit_backend
from repro_torch.backend import ShardedSsdBackend, make_backend
from repro_torch.core.bitweaving import Column, RowCodec
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.range_query import (RangePlan, approximate_range,
                                          exact_range)
from repro_torch.frontend import RunConfig, replay
from repro_torch.index.btree import SimBTree
from repro_torch.index.hashindex import BUCKET_CAPACITY, SimHashIndex
from repro_torch.index.secondary import SimSecondaryIndex
from repro_torch.kernels import layout, native
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.layout import words_to_tensor
from repro_torch.kernels.sim_fused.ops import sim_fused, sim_fused_lookup
from repro_torch.kernels.sim_fused.ref import sim_fused_ref, sim_lookup_ref
from repro_torch.kernels.sim_gather.ops import sim_gather
from repro_torch.kernels.sim_gather.ref import sim_gather_ref
from repro_torch.kernels.sim_plan.ops import sim_plan, sim_plan_chips
from repro_torch.kernels.sim_plan.ref import (PASS_EXCLUDE, PASS_INCLUDE,
                                              PASS_PAD, plan_pass_rows,
                                              sim_plan_chips_ref,
                                              sim_plan_ref)
from repro_torch.kernels.sim_search.ops import sim_search, sim_search_chips
from repro_torch.kernels.sim_search.ref import (sim_search_chips_ref,
                                                sim_search_ref, stream_planes)
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import param_tree, params_from_numpy, params_to_numpy
from repro_torch.launch.serve import requests, serve
from repro_torch.models.layers import plain_attention
from repro_torch.models.model import init_model
from repro_torch.reliability import (DegradedReadError, FaultModel,
                                     FaultSchedule, ReliabilityPolicy,
                                     ReliabilityState, UncorrectableReadError)
from repro_torch.serve.batching import ServeEngine
from repro_torch.serve.kvcache import SimPagedKVCache
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step, value_and_grad
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
    lo, hi, bm = (words_to_tensor(_u32(rng, shape), dev)
                  for shape in ((n_pages, 512), (n_pages, 512), (n_pages, 2)))
    before = native.LAUNCHES["sim_gather"]
    got = sim_gather(lo, hi, bm, max_out=max_out)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sim_gather"] == before + 1
    _check_equal(got, sim_gather_ref(lo, hi, bm, max_out))


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


@pytest.mark.gpu
@pytest.mark.parametrize("n_pages,n_queries,max_out", [
    (64, 8, 16), (17, 3, 4), (5, 2, 64), (1, 1, 0),
    (33, 17, 16),        # Q fills no query tile of 8 warps evenly
    (2048, 64, 16),      # the smoke's shape: one 64-query tile a page
    (7, 5, 80),          # max_out past 64: rows 64.. are always zero
    (3, 130, 4),         # several query tiles a page, a ragged last one
])
def test_sim_fused_kernel_matches_plain(n_pages, n_queries, max_out):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_pages * 5 + n_queries)
    lo, hi = _u32(rng, (n_pages, 512)), _u32(rng, (n_pages, 512))
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = _u32(rng, (n_pages,))
    for randomized in (False, True):
        s_lo, s_hi = _stream(ids, seeds) if randomized else (
            np.zeros_like(lo), np.zeros_like(hi))
        # query 0: a header slot and a user slot; the next a 4-bit mask (many
        # chunks, past max_out); the last mask 0 (all 64 chunks)
        q, m = _u32(rng, (n_queries, 2)), _u32(rng, (n_queries, 2))
        p = n_pages - 1
        q[0] = [lo[p, 3] ^ s_lo[p, 3], hi[p, 3] ^ s_hi[p, 3]]
        lo[p, 300], hi[p, 300] = q[0, 0] ^ s_lo[p, 300], q[0, 1] ^ s_hi[p, 300]
        m[0] = [0xFFFFFFFF, 0xFFFFFFFF]
        if n_queries > 1:
            m[1] = [0xF, 0]
            q[-1], m[-1] = 0, 0
        args = [words_to_tensor(a, dev) for a in (lo, hi, q, m)]
        kw = dict(max_out=max_out, randomized=randomized,
                  page_ids=words_to_tensor(ids, dev),
                  page_seeds=words_to_tensor(seeds, dev))
        before = native.LAUNCHES["sim_fused"]
        got = sim_fused(*args, **kw)
        torch.cuda.synchronize()
        assert native.LAUNCHES["sim_fused"] == before + 1
        plain = sim_fused_ref(*args, kw["page_ids"], kw["page_seeds"],
                              max_out=max_out, randomized=randomized)
        assert int(plain[2][0, p]) == 2               # chunks 0 and 37
        if n_queries > 1:
            assert (plain[2][-1] == 64).all()
        _check_equal(got, plain)


def _attn_inputs(dev, dtype, b, sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
            .to(dev, dtype) for s, n in ((sq, h), (sk, hkv), (sk, hkv))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", [
    ((2, 256, 256, 4, 2, 64), dict(causal=True)),
    ((2, 256, 256, 4, 2, 64), dict(causal=False)),
    ((2, 256, 256, 4, 2, 64), dict(causal=True, window=128)),
    ((1, 16, 16, 32, 8, 128), dict(causal=True)),
    ((1, 1, 128, 32, 8, 128), dict(causal=True, q_offset=5)),
    ((1, 1, 128, 32, 8, 128), dict(causal=True, q_offset=127)),
    ((2, 37, 70, 6, 2, 32), dict(causal=True, window=9)),
    ((1, 5, 3, 2, 1, 32), dict(causal=True, q_offset=-2)),
])
def test_flash_attention_kernel_matches_plain(dtype, shape, kw):
    dev = _cuda_or_skip()
    q, k, v = _attn_inputs(dev, dtype, *shape, seed=sum(shape))
    before = native.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == before + 1
    plain = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=tol)


def _check_attention(dev, dtype, shape, kw, seed):
    q, k, v = _attn_inputs(dev, dtype, *shape, seed=seed)
    before = native.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == before + 1
    plain = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{shape} {kw}: {m}")
    return plain


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
def test_flash_attention_head_dims_and_groups(d, group, dtype):
    """Every head dim the repo's configs use and GQA groups 1-8: prefill
    rows Sq in {1, 4, 16, 17, 64, 256} against Sk = Sq + 13 (never a
    multiple of the 64-key tile), and one-row decodes at q_offsets on the
    tile edges of a 131-key cache."""
    dev = _cuda_or_skip()
    hkv = 2
    for sq in (1, 4, 16, 17, 64, 256):
        _check_attention(dev, dtype, (1, sq, sq + 13, hkv * group, hkv, d),
                         dict(causal=True), seed=d + group + sq)
    for q_offset in (0, 31, 32, 63, 64, 127):
        _check_attention(dev, dtype, (2, 1, 131, hkv * group, hkv, d),
                         dict(causal=True, q_offset=q_offset),
                         seed=d * group + q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_windows_and_empty_rows(dtype):
    """A window with no causal mask, rows that see no key (a window past
    every key, causal rows before position 0: those rows give 0), and
    decodes over long key ranges."""
    dev = _cuda_or_skip()
    _check_attention(dev, dtype, (2, 40, 90, 8, 2, 64),
                     dict(causal=False, window=24, q_offset=30), seed=1)
    plain = _check_attention(dev, dtype, (1, 20, 70, 4, 1, 16),
                             dict(causal=False, window=8, q_offset=70),
                             seed=2)
    assert (plain[:, 8:] == 0).all() and (plain[:, :7] != 0).any()
    plain = _check_attention(dev, dtype, (1, 24, 80, 4, 2, 112),
                             dict(causal=True, q_offset=-5), seed=3)
    assert (plain[:, :5] == 0).all() and (plain[:, 5:] != 0).any()
    # Decodes over long ranges, whose keys split over the warps of a block
    # and merge through shared memory from many chunks: a window inside a
    # long cache, no causal mask.
    _check_attention(dev, dtype, (2, 1, 300, 8, 2, 64),
                     dict(causal=True, window=100, q_offset=250), seed=4)
    _check_attention(dev, dtype, (1, 2, 200, 8, 2, 128),
                     dict(causal=False), seed=5)
    _check_attention(dev, dtype, (3, 1, 1000, 4, 4, 32),
                     dict(causal=True, q_offset=999), seed=6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", [
    ((2, 64, 64, 8, 2, 64), dict(causal=True, q_offset=0)),
    ((1, 96, 96, 4, 4, 128), dict(causal=True, window=32, q_offset=0)),
    ((2, 17, 17, 16, 16, 16), dict(causal=True, q_offset=0)),
])
def test_flash_attention_gradient_is_the_attend_vjp(dtype, shape, kw):
    """Under autograd the kernel's output has a ``grad_fn`` and the kernel
    launches once; q, k and v gradients equal the VJP of the plain
    ``attend`` on the same inputs bitwise (the backward recomputes it, on
    one stream); the forward is within the kernel's tolerance of its plain
    version.  Under ``no_grad``, and for inputs that need no gradient, the
    output has no ``grad_fn``."""
    dev = _cuda_or_skip()
    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        dev, dtype, *shape, seed=sum(shape)))
    g = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(
        1), device=dev).to(dtype)
    before = native.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None and out.requires_grad
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == before + 1
    want = torch.autograd.grad(plain_attention(q, k, v, **kw), (q, k, v), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.detach().float(), attention_ref(
        q.detach(), k.detach(), v.detach(), **kw).float(), atol=tol, rtol=tol)
    with torch.no_grad():
        assert flash_attention(q, k, v, **kw).grad_fn is None
    assert flash_attention(q.detach(), k.detach(), v.detach(),
                           **kw).grad_fn is None
    assert flash_attention(q.detach(), k, v.detach(), **kw).grad_fn \
        is not None
    assert native.LAUNCHES["flash_attention"] == before + 4


@pytest.mark.gpu
def test_train_steps_on_card_launch_the_kernel_and_match_plain():
    """Reduced olmo-1b in float32 on the card: three steps launch the kernel
    twice a layer a step (forward and the remat recompute), every
    parameter gets a finite gradient, and one step's loss and gradients
    are within 1e-4 of the same step with the plain attention."""
    dev = _cuda_or_skip()
    cfg = dataclasses.replace(reduced_config(get_config("olmo-1b")),
                              dtype="float32")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                      seed=0)
    model = init_model(cfg, seed=0, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = init_opt_state(param_tree(model), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    native.reset_launches()
    for s in range(3):
        model, state, m = step(model, state, batch_at_step(data, s,
                                                           device=dev))
        assert np.isfinite(float(m["loss"]))
    assert native.LAUNCHES["flash_attention"] == 3 * 2 * cfg.n_layers
    b = batch_at_step(data, 3, device=dev)
    (loss, _), grads = value_and_grad(model, b["tokens"], b["labels"])
    (ploss, _), pgrads = value_and_grad(model, b["tokens"], b["labels"],
                                        attention=plain_attention)
    assert abs(float(loss) - float(ploss)) < 1e-4
    for name, t in grads.items():
        assert torch.isfinite(t).all(), name
        ref = pgrads[name]
        assert float((t - ref).norm() / ref.norm().clamp(min=1e-30)) < 1e-4


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    q, k, v = _attn_inputs(dev, torch.float16, 1, 4, 4, 2, 1, 32, 0)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)                     # float16
    for d in (40, 144):                              # not a multiple of 16
        q, k, v = _attn_inputs(dev, torch.float32, 1, 4, 4, 2, 1, d, 0)
        with pytest.raises(ValueError):
            flash_attention(q, k, v)
    q, k, v = _attn_inputs(dev, torch.float32, 1, 4, 4, 2, 1, 32, 0)
    with pytest.raises(ValueError):
        flash_attention(q, k.bfloat16(), v)          # mismatched dtypes


@pytest.mark.gpu
@pytest.mark.parametrize("as_is", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_serve_on_card_matches_cpu(paged, as_is):
    """A reduced qwen3-4b served on the card and on the CPU with the same
    weights: the greedy token counts and the block table's counters agree,
    and every attention on the card ran the kernel.  ``as_is`` serves the
    reduced config as it is (16-wide heads); otherwise with head_dim 32 in
    float32."""
    dev = _cuda_or_skip()
    cfg = reduced_config(get_config("qwen3-4b"))
    if as_is:
        assert cfg.head_dim == 16
    else:
        cfg = dataclasses.replace(cfg, head_dim=32, dtype="float32")
    cpu_model = init_model(cfg, seed=0, device="cpu")
    runs = {}
    for device in (dev, torch.device("cpu")):
        model = cpu_model if device.type == "cpu" else params_from_numpy(
            params_to_numpy(cpu_model), cfg, device=dev)
        cache = SimPagedKVCache(cfg, n_pages=64, page_tokens=4,
                                device=device) if paged else None
        engine = ServeEngine(model, max_slots=2, cache_len=32,
                             paged_cache=cache)
        for req in requests(4, cfg.vocab_size, 0):
            engine.submit(req)
        before = native.LAUNCHES["flash_attention"]
        engine.run()
        runs[device.type] = (engine, cache,
                             native.LAUNCHES["flash_attention"] - before)
    (card, card_cache, launched), (cpu, cpu_cache, none) = (runs["cuda"],
                                                            runs["cpu"])
    assert launched == cfg.n_layers * (card.prefills + card.decodes) > 0
    assert none == 0
    assert [len(c.tokens) for c in card.completed] == [
        len(c.tokens) for c in cpu.completed]
    if paged:
        assert card_cache.stats == cpu_cache.stats
        assert card_cache.stats.pages_freed == \
            card_cache.stats.pages_allocated > 0


@pytest.mark.gpu
def test_serve_launcher_reduced_on_card():
    """``python -m repro_torch.launch.serve --arch qwen3-4b --paged``: the
    reduced config on the default device, the card, through the kernel."""
    _cuda_or_skip()
    cfg = reduced_config(get_config("qwen3-4b"))
    before = native.LAUNCHES["flash_attention"]
    completions, engine, cache = serve("qwen3-4b", paged=True, verbose=False)
    torch.cuda.synchronize()
    assert engine.model.cfg.head_dim == 16
    assert native.LAUNCHES["flash_attention"] - before == \
        cfg.n_layers * (engine.prefills + engine.decodes) > 0
    assert len(completions) == 8
    assert cache.stats.pages_freed == cache.stats.pages_allocated > 0


def _random_pass_rows(rng, keys, p_pad, kinds):
    """p_pad pass rows drawn from ``kinds`` (PASS_* flags, interleaved with
    PAD rows): each query is a stored 64-bit key under a random mask of
    about 6 bits, so a pass matches a few slots of most pages."""
    n = keys.shape[0]
    f = rng.choice(np.asarray(kinds, np.uint32), size=p_pad)
    pick = keys[rng.integers(n, size=p_pad), rng.integers(512, size=p_pad)]
    q = np.stack([(pick & 0xFFFFFFFF).astype(np.uint32),
                  (pick >> np.uint64(32)).astype(np.uint32)], axis=1)
    m = np.zeros_like(q)
    for r in range(p_pad):
        bits = rng.choice(64, size=6, replace=False)
        for b in bits:
            m[r, b // 32] |= np.uint32(1 << (b % 32))
    q[f == PASS_PAD], m[f == PASS_PAD] = 0, 0
    return q, m, f


@pytest.mark.gpu
@pytest.mark.parametrize("n_pages", [1, 37])
@pytest.mark.parametrize("p_pad", [16, 128, 257, 600])
@pytest.mark.parametrize("n_groups", [1, 2, 3])
def test_sim_plan_groups_and_pass_counts(n_groups, p_pad, n_pages):
    """Bit-exact against the plain version at G in {1, 2, 3} and P up to
    600 (past one staging tile of 512 rows): group 0 mixes include,
    exclude and PAD rows, group 1 has exclude rows only (all zero), group 2
    is all PAD (all zero)."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_groups * 1000 + p_pad + n_pages)
    keys = rng.integers(1, 2**64, (n_pages, 512), dtype=np.uint64)
    kinds = [(PASS_INCLUDE, PASS_EXCLUDE, PASS_PAD), (PASS_EXCLUDE, PASS_PAD),
             (PASS_PAD,)]
    rows = [_random_pass_rows(rng, keys, p_pad, kinds[g])
            for g in range(n_groups)]
    rows[0][2][0] = PASS_INCLUDE
    q, m, f = (np.stack([r[i] for r in rows]) for i in range(3))
    ids = rng.integers(0, 4096, n_pages).astype(np.uint32)
    seeds = _u32(rng, (n_pages,))
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
        ones = np.unpackbits(plain.cpu().numpy().view(np.uint8), axis=-1)
        assert ones[0].any() and not ones[1:].any()
        _check_equal([got], [plain])


# ------------------------------------------------ in place: arena row indices

@pytest.mark.gpu
@pytest.mark.parametrize("n_pages,max_out", [(1, 64), (5, 4), (13, 16),
                                             (64, 64), (64, 1), (70, 80),
                                             (33, 0)])
def test_sim_gather_in_place_matches_plain(n_pages, max_out):
    """Chunks read through arena rows (repeats, pad rows of row 0 with
    bitmap 0, rows past the first 32): one chunk a row as the replay
    gathers, random selections past max_out, the header chunk alone, the
    last chunk alone and all 64; also through ``rows=None``."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_pages * 11 + max_out)
    cap = 2 * n_pages + 40
    lo, hi = _u32(rng, (cap, 512)), _u32(rng, (cap, 512))
    rows = rng.integers(1, cap, n_pages).astype(np.int32)
    bm = np.zeros((n_pages, 2), np.uint32)
    one = rng.integers(0, 64, n_pages)
    bm[np.arange(n_pages), one // 32] = 1 << (one % 32).astype(np.uint32)
    bm[1::3] = _u32(rng, (len(bm[1::3]), 2))
    if n_pages > 4:
        bm[2], bm[3], bm[4] = [1, 0], [0, 1 << 31], [0xFFFFFFFF] * 2
        rows[5 % n_pages] = rows[0]              # a repeat
        rows[-1], bm[-1] = 0, 0                  # a pad row
    args = [words_to_tensor(a, dev) for a in (lo, hi, bm)]
    idx = words_to_tensor(rows.view(np.uint32), dev)
    before = native.LAUNCHES["sim_gather"]
    got = sim_gather(*args, max_out=max_out, rows=idx)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sim_gather"] == before + 1
    plain = sim_gather_ref(*args, max_out, rows=idx)
    assert got[0].shape == (n_pages, max_out, 16)
    _check_equal(got, plain)
    every = [words_to_tensor(a[:n_pages], dev) for a in (lo, hi)]
    _check_equal(sim_gather(*every, args[2], max_out=max_out),
                 sim_gather_ref(*every, args[2], max_out))


@pytest.mark.gpu
@pytest.mark.parametrize("n_pages,n_queries", [(1, 1), (5, 5), (13, 13),
                                               (64, 64), (70, 5), (5, 70),
                                               (3, 130), (64, 200)])
def test_sim_search_in_place_matches_plain(n_pages, n_queries):
    """Pages read through arena rows (repeats, pad rows of row 0, rows past
    the first 32), query counts past one 64-query tile and ragged last
    tiles; the last query is a pad query (q = 0, m = 0) that matches
    every slot."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_pages * 7 + n_queries)
    cap = 2 * n_pages + 40
    lo, hi = _u32(rng, (cap, 512)), _u32(rng, (cap, 512))
    ids = rng.integers(0, 4096, cap).astype(np.uint32)
    seeds = _u32(rng, (cap,))
    rows = rng.integers(1, cap, n_pages).astype(np.int32)
    if n_pages > 2:
        rows[1], rows[-1] = rows[0], 0            # a repeat, a pad row
    q, m = _u32(rng, (n_queries, 2)), _u32(rng, (n_queries, 2))
    m[1::2] = [0xF, 0]
    if n_queries > 1:
        q[-1], m[-1] = 0, 0
    r, s = int(rows[0]), 77
    for randomized in (False, True):
        s_lo, s_hi = _stream(ids, seeds) if randomized else (
            np.zeros_like(lo), np.zeros_like(hi))
        q[0] = [lo[r, s] ^ s_lo[r, s], hi[r, s] ^ s_hi[r, s]]
        m[0] = [0xFFFFFFFF, 0xFFFFFFFF]
        args = [words_to_tensor(a, dev) for a in (lo, hi, q, m, ids, seeds)]
        idx = words_to_tensor(rows.view(np.uint32), dev)
        before = native.LAUNCHES["sim_search"]
        got = sim_search(*args, randomized=randomized, rows=idx)
        torch.cuda.synchronize()
        assert native.LAUNCHES["sim_search"] == before + 1
        plain = sim_search_ref(*args, randomized=randomized, rows=idx)
        assert got.shape == (n_queries, n_pages, 16)
        assert (int(plain[0, 0, s // 32]) >> (s % 32)) & 1
        if n_queries > 1:
            assert (plain[-1] == -1).all()        # the pad query
        _check_equal([got], [plain])


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [1, 5, 13, 64, 70])
def test_sim_lookup_in_place_matches_plain(n_rows):
    """Key and value pages read through two row indices into one arena:
    user-slot hits (a header slot holding the same key loses), header-only
    misses, random misses and pad rows (key and value row 0, all-ones
    mask, as the backend pads); value rows repeat and interleave with key
    rows."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_rows + 100)
    cap = 2 * n_rows + 40
    lo, hi = _u32(rng, (cap, 512)), _u32(rng, (cap, 512))
    ids = rng.integers(0, 4096, cap).astype(np.uint32)
    seeds = _u32(rng, (cap,))
    key_rows = rng.choice(np.arange(1, cap), n_rows,
                          replace=False).astype(np.int32)
    value_rows = rng.integers(0, cap, n_rows).astype(np.int32)
    if n_rows > 4:
        key_rows[-1] = value_rows[-1] = 0          # a pad row
        value_rows[1] = key_rows[0]                # interleave
    m = np.full((n_rows, 2), 0xFFFFFFFF, np.uint32)
    for randomized in (False, True):
        s_lo, s_hi = _stream(ids, seeds) if randomized else (
            np.zeros_like(lo), np.zeros_like(hi))
        q = _u32(rng, (n_rows, 2))
        want = np.full(n_rows, 512)
        for i, r in enumerate(key_rows):
            if r == 0:
                q[i] = 0
                continue
            kind = i % 3                           # hit, header-only, miss
            if kind == 2:
                continue
            s = int(rng.integers(8, 512)) if kind == 0 else 3
            q[i] = [lo[r, s] ^ s_lo[r, s], hi[r, s] ^ s_hi[r, s]]
            lo[r, 3], hi[r, 3] = q[i, 0] ^ s_lo[r, 3], q[i, 1] ^ s_hi[r, 3]
            if kind == 0:
                want[i] = s
        args = [words_to_tensor(a, dev) for a in (lo, hi, lo, hi, q, m, ids,
                                                  seeds)]
        kw = dict(randomized=randomized,
                  key_rows=words_to_tensor(key_rows.view(np.uint32), dev),
                  value_rows=words_to_tensor(value_rows.view(np.uint32), dev))
        before = native.LAUNCHES["sim_lookup"]
        got = sim_fused_lookup(*args, **kw)
        torch.cuda.synchronize()
        assert native.LAUNCHES["sim_lookup"] == before + 1
        plain = sim_lookup_ref(*args, **kw)
        np.testing.assert_array_equal(plain[2].cpu().numpy(), want)
        _check_equal(got, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["search", "lookup", "gather"])
def test_reprogram_between_flush_and_drain_on_card(kind):
    """A burst flushed before its page is reprogrammed, restaged and the
    arena grown (by the next flush, queued after the launch on the same
    stream) resolves against the planes of its flush, as on the CPU."""
    _cuda_or_skip()
    old = np.arange(1, 301, dtype=np.uint64) * 7
    new = np.arange(1, 301, dtype=np.uint64) * 11
    results = {}
    for device in (None, "cpu"):               # None: the card
        arr = SimChipArray(n_chips=5, pages_per_chip=8, device_seed=4)
        for p in range(40):
            arr.program_entries(p, old + p)
        be = make_backend("batched", arr, device=device)
        cmd = {"search": Command.search(1, int(old[9] + 1)),
               "lookup": Command.lookup(1, 2, int(old[9] + 1)),
               "gather": Command.gather(1, 0b11 | 1 << 63)}[kind]
        submit = getattr(be, f"submit_{kind}")
        first = [submit(cmd)]
        for p in range(2, 4):                   # 4 resident rows of 32
            first.append(submit({"search": Command.search(p, 1),
                                 "lookup": Command.lookup(p, p + 1, 1),
                                 "gather": Command.gather(p, 0b110)}[kind]))
        be.flush()
        arr.program_entries(1, new + 1)
        arr.program_entries(2, new + 2)
        second = [submit(cmd)] + [be.submit_search(Command.search(p, 1))
                                  for p in range(40)]
        be.flush()                             # restages rows 1, 2; grows
        assert be.store.resident_rows == 40
        results[device] = [t.result() for t in first + second]
    card, cpu = results[None], results["cpu"]
    if kind == "search":
        assert card[0].match_count == 1 and card[3].match_count == 0
    elif kind == "lookup":
        assert card[0].value_slot == 8 + 9 and card[0].parity_ok
        assert card[3].value_slot is None
    else:
        # The first gather read page 1's old image, the second its new one.
        assert list(card[0].chunk_ids) == [0, 1, 63]
        assert card[0].parity_ok.all() and card[3].parity_ok.all()
        assert not np.array_equal(card[0].chunks[1], card[3].chunks[1])
    for a, b in zip(card, cpu):
        if kind == "gather" and hasattr(a, "chunks"):
            np.testing.assert_array_equal(a.chunks, b.chunks)
            np.testing.assert_array_equal(a.chunk_ids, b.chunk_ids)
            np.testing.assert_array_equal(a.parity_ok, b.parity_ok)
            continue
        if kind == "lookup" and hasattr(a, "search"):
            assert (a.value_slot, a.value, a.parity_ok) == \
                (b.value_slot, b.value, b.parity_ok)
            a, b = a.search, b.search
        np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)


@pytest.mark.gpu
def test_counted_copies_are_the_traces_memcpys_and_launches_map():
    """``layout.COPIES`` over three lookup flushes (the first with a
    restage) and three plan flushes, their tails included, equals the
    profiler's Memcpy events by direction, and every SiM kernel starts
    after the mapped start of the ``kernel.launch`` span that issued it."""
    dev = _cuda_or_skip()
    arr = SimChipArray(n_chips=4, pages_per_chip=8, device_seed=2)
    be = make_backend("batched", arr, device=dev)
    keys = np.arange(1, 101, dtype=np.uint64)
    for p in range(16):
        be.program_entries(p, keys + 1000 * p)
    plan = exact_range(10, 60, width=64)
    for t in [be.submit_lookup(Command.lookup(p, p + 8, 5))
              for p in range(8)] + [
            be.submit_plan(Command.plan(p, plan.include, plan.exclude))
            for p in range(8)]:
        t.result()                          # stages, builds, warms
    be.program_entries(3, keys * 3)         # restaged by the first flush
    torch.cuda.synchronize(dev)
    layout.reset_copies()
    spans.reset()
    spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall, perf = time.time_ns(), time.perf_counter_ns()
        spans.mark()
        got = []
        for _ in range(3):
            lookups = [be.submit_lookup(Command.lookup(
                p, p + 8, int(keys[3]) + 1000 * p)) for p in (0, 1, 2)]
            lookups.append(be.submit_lookup(Command.lookup(3, 11, 12)))
            be.flush()
            plans = [be.submit_plan(Command.plan(p, plan.include,
                                                 plan.exclude))
                     for p in (1, 2, 4)]
            be.flush()
            got += [t.result().value_slot for t in lookups]
            for t in plans:
                t.result()
        torch.cuda.synchronize(dev)
        spans.disable()
    assert got == [11] * 12
    events = prof.profiler.kineto_results.events()
    on_card = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    copies = collections.Counter(
        "h2d" if "HtoD" in e.name() else "d2h" for e in on_card
        if e.name().startswith("Memcpy"))
    # Restage: indices + 4 planes; a lookup flush: rows + q + m; a plan
    # flush: take's rows + q + m + f; tails: 3 outputs, 1 output.
    assert dict(copies) == {"h2d": 5 + 3 * (3 + 4), "d2h": 3 * (3 + 1)}
    assert (layout.COPIES["h2d"], layout.COPIES["d2h"]) == (26, 12)
    kernels, runtime = spans.trace_launches(events)
    pairs = spans.launch_pairs(spans.records(), kernels, native.TRACE_NAMES)
    assert pairs is not None and len(pairs) == 6
    cal = spans.clock_offset(pairs, runtime)
    offset = wall - perf if cal is None else cal[0]
    drift = spans.device_drift(pairs, runtime)
    violations, lag = spans.check_launches(pairs, offset, drift)
    assert violations == 0 and lag >= 0
    spans.reset()


# ------------------------------------------------------- the §V indexes

def _index_backends(n_chips, per_chip):
    """(the batched backend on the card, ScalarBackend) over two fresh chip
    arrays of one geometry."""
    dev = _cuda_or_skip()
    return (make_backend("batched", SimChipArray(n_chips, per_chip),
                         device=dev),
            make_backend("scalar", SimChipArray(n_chips, per_chip)))


def _grew(before):
    torch.cuda.synchronize()
    return {k: native.LAUNCHES[k] - before[k] for k in before
            if native.LAUNCHES[k] != before[k]}


@pytest.mark.gpu
def test_btree_on_card_matches_scalar():
    card, ref = _index_backends(8, 64)
    rng = np.random.default_rng(42)
    keys = (rng.choice(10**9, size=3000, replace=False) + 1).astype(np.uint64)
    trees = [SimBTree(be) for be in (card, ref)]
    for t in trees:
        t.bulk_load(keys, keys * np.uint64(13))
    probes = [int(k) for k in keys[::100]] + [int(keys[0]) + 1,
                                              int(keys.min()) - 1]
    before = dict(native.LAUNCHES)
    got = trees[0].lookup_batch(probes)
    assert _grew(before) == {"sim_lookup": 1}
    assert got == trees[1].lookup_batch(probes)
    assert got[:30] == [int(k) * 13 for k in keys[::100]]
    before = dict(native.LAUNCHES)
    assert trees[0].lookup_batch([0, 1]) == [None, None]
    assert _grew(before) == {}                 # below the first separator
    for q in ((40, 43), (0, 100)):
        lo, hi = (int(np.percentile(keys, q[0])),
                  int(np.percentile(keys, q[1])))
        before = dict(native.LAUNCHES)
        rows = trees[0].range_query(lo, hi)
        assert _grew(before) == {"sim_plan": 1, "sim_gather": 1}
        assert rows == trees[1].range_query(lo, hi)
        assert sorted(rows) == sorted((int(k), int(k) * 13) for k in keys
                                      if lo <= k < hi)
    assert trees[0].stats == trees[1].stats
    assert card.stats.result_bytes == ref.stats.result_bytes


@pytest.mark.gpu
def test_hash_split_on_card_after_buffered_inserts():
    """A split right after buffered inserts: the buffer's reprogram lands
    in the arena before the split's search reads the key page (one
    stream), and each split is one sim_search and one sim_gather."""
    card, ref = _index_backends(4, 256)
    rng = np.random.default_rng(5)
    keys = (rng.choice(10**9, size=4 * BUCKET_CAPACITY + 1,
                       replace=False) + 1).astype(np.uint64)
    idx = [SimHashIndex(be, global_depth=0, write_high_water=10**6)
           for be in (card, ref)]
    for h in idx:
        for k in keys[:BUCKET_CAPACITY]:
            h.insert(int(k), int(k) % 1013)
    assert idx[0].write_buffer.n_dirty == 2
    before = dict(native.LAUNCHES)
    for h in idx:
        h.insert(int(keys[BUCKET_CAPACITY]), 1)
    assert idx[0].splits == 1
    assert _grew(before) == {"sim_search": 1, "sim_gather": 1}
    assert idx[0].split_gathered_chunks == idx[1].split_gathered_chunks
    assert idx[0].split_gathered_chunks == 63   # mask 0: every user chunk
    for h in idx:
        for k in keys[BUCKET_CAPACITY + 1:]:
            h.insert(int(k), int(k) % 1013)
    assert idx[0].splits == idx[1].splits > 1
    probes = [int(k) for k in keys[::9]] + [10**12 + 7]
    idx[0].flush_writes()
    before = dict(native.LAUNCHES)
    got = idx[0].lookup_batch(probes)
    assert _grew(before) == {"sim_search": 1, "sim_gather": 1}
    assert got == idx[1].lookup_batch(probes)
    assert got[:-1] == [k % 1013 if i != BUCKET_CAPACITY else 1
                        for i, k in enumerate(int(k) for k in keys)][::9]
    assert (idx[0].global_depth, idx[0].directory) == \
        (idx[1].global_depth, idx[1].directory)
    assert card.stats.result_bytes == ref.stats.result_bytes


@pytest.mark.gpu
def test_secondary_index_on_card_matches_scalar():
    card, ref = _index_backends(4, 64)
    rng = np.random.default_rng(4)
    codec = RowCodec([Column("gender", 1), Column("age", 7),
                      Column("salary", 20), Column("uid", 32)])
    n = 3000
    rows = {"gender": rng.integers(0, 2, n), "age": rng.integers(0, 128, n),
            "salary": rng.integers(0, 10_000, n), "uid": np.arange(n)}
    idx = [SimSecondaryIndex(be, codec) for be in (card, ref)]
    for si in idx:
        si.load_rows(rows)
    before = dict(native.LAUNCHES)
    fem = idx[0].select_equals("gender", 1)
    assert _grew(before) == {"sim_plan": 1, "sim_gather": 1}
    np.testing.assert_array_equal(fem, idx[1].select_equals("gender", 1))
    want = set(np.nonzero((rows["salary"] >= 2001)
                          & (rows["salary"] < 7000))[0].tolist())
    for exact in (True, False):
        before = dict(native.LAUNCHES)
        got = idx[0].select_range("salary", 2001, 7000, exact=exact)
        assert _grew(before) == {"sim_plan": 1, "sim_gather": 1}
        np.testing.assert_array_equal(
            got, idx[1].select_range("salary", 2001, 7000, exact=exact))
        assert set(codec.decode_rows(got, "uid").tolist()) == want
    assert (idx[0].io_bitmap_bytes, idx[0].io_chunk_bytes) == \
        (idx[1].io_bitmap_bytes, idx[1].io_chunk_bytes)
    assert card.stats.result_bytes == ref.stats.result_bytes


@pytest.mark.gpu
def test_database_index_on_card_matches_cpu():
    _cuda_or_skip()
    before = dict(native.LAUNCHES)
    card = database_index.main()
    grew = _grew(before)
    assert card == database_index.main(device="cpu")
    assert card["hash_ok"] and card["splits"] > 0
    assert grew == {"sim_lookup": 1, "sim_plan": 1,
                    "sim_search": card["splits"] + 1,
                    "sim_gather": 1 + card["splits"] + 1}


# ------------------------------------------- chip-axis forms, sharded SSD

def _chip_axis_rows(rng, n_chips, n_rows, cap):
    """(C, R) arena rows: distinct random rows, chip 1 repeating a row of
    chip 0, every chip's last four rows pad rows (row 0), and with C > 1
    the last chip a pad chip (all row 0), as the sharded backend pads."""
    rows = rng.choice(np.arange(1, cap), n_chips * n_rows, replace=False)
    rows = rows.reshape(n_chips, n_rows).astype(np.int32)
    rows[:, -4:] = 0
    if n_chips > 1:
        rows[1, 0] = rows[0, 1]
        rows[-1] = 0
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("n_chips", [1, 3, 16])
def test_sim_search_chips_in_place_matches_plain(n_chips):
    """The chip-axis search at the smoke's shapes (Q = 64 and R = 64 a
    chip, in place): one launch, equal to the plain version; chip c's
    first query hits a planted slot of its first row, a 4-bit mask hits
    many, the last query (q = 0, m = 0) every slot."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(n_chips)
    n_q, n_r = 64, 64
    cap = n_chips * n_r + 64
    lo, hi = _u32(rng, (cap, 512)), _u32(rng, (cap, 512))
    ids = rng.integers(0, 4096, cap).astype(np.uint32)
    seeds = _u32(rng, (cap,))
    rows = _chip_axis_rows(rng, n_chips, n_r, cap)
    s_lo, s_hi = _stream(ids, seeds)
    q, m = _u32(rng, (n_chips, n_q, 2)), np.full((n_chips, n_q, 2),
                                                 0xFFFFFFFF, np.uint32)
    for c in range(n_chips):
        r = int(rows[c, 0])
        q[c, 0] = [lo[r, 77] ^ s_lo[r, 77], hi[r, 77] ^ s_hi[r, 77]]
    m[:, 1] = [0xF, 0]
    q[:, -1] = m[:, -1] = 0
    args = [words_to_tensor(a, dev) for a in (lo, hi, q, m, ids, seeds)]
    idx = torch.from_numpy(rows).to(dev)
    before = native.LAUNCHES["sim_search"]
    got = sim_search_chips(*args, randomized=True, rows=idx)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sim_search"] == before + 1
    plain = sim_search_chips_ref(*args, randomized=True, rows=idx)
    assert got.shape == (n_chips, n_q, n_r, 16)
    for c in range(n_chips):
        assert (int(plain[c, 0, 0, 77 // 32]) >> (77 % 32)) & 1
        # Chip c of the chip axis is the single-chip search of its rows.
        _check_equal([plain[c]], [sim_search_ref(
            *args[:2], args[2][c], args[3][c], *args[4:], randomized=True,
            rows=idx[c])])
    assert (plain[:, -1] == -1).all()
    _check_equal([got], [plain])


@pytest.mark.gpu
@pytest.mark.parametrize("n_chips", [1, 3, 16])
def test_sim_plan_chips_matches_plain(n_chips):
    """The chip-axis plan at the smoke's shapes (G = 2, P = 16, R = 32 a
    chip): one launch, equal to the plain version.  Passes match on 16-bit
    prefixes of stored words, so includes and excludes both hit; odd
    chips' second group is all PAD and matches nothing."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(40 + n_chips)
    n_g, n_p, n_r = 2, 16, 32
    lo, hi = (_u32(rng, (n_chips, n_r, 512)) for _ in range(2))
    ids = rng.integers(0, 4096, (n_chips, n_r)).astype(np.uint32)
    seeds = _u32(rng, (n_chips, n_r))
    q = np.zeros((n_chips, n_g, n_p, 2), np.uint32)
    m, f = np.zeros_like(q), np.zeros((n_chips, n_g, n_p), np.uint32)
    for c in range(n_chips):
        s_lo, s_hi = _stream(ids[c], seeds[c])
        for g in range(n_g if c % 2 == 0 else 1):
            for p in range(12):
                r, s = int(rng.integers(n_r)), int(rng.integers(512))
                q[c, g, p] = [lo[c, r, s] ^ s_lo[r, s], hi[c, r, s]
                              ^ s_hi[r, s]]
                m[c, g, p] = [0, 0xFFFF0000]
                f[c, g, p] = PASS_EXCLUDE if p % 4 == 3 else PASS_INCLUDE
    args = [words_to_tensor(a, dev) for a in (lo, hi, q, m, f, ids, seeds)]
    before = native.LAUNCHES["sim_plan"]
    got = sim_plan_chips(*args, randomized=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sim_plan"] == before + 1
    plain = sim_plan_chips_ref(*args, randomized=True)
    assert got.shape == (n_chips, n_g, n_r, 16)
    assert (plain[:, 0] != 0).any() and not (plain[1::2, 1] != 0).any()
    for c in range(n_chips):
        _check_equal([plain[c]], [sim_plan_ref(
            *(a[c] for a in args), randomized=True)])
    _check_equal([got], [plain])


def _sharded_burst(keys, n_pages):
    """Searches, plans, lookups across chips and gathers: every phase."""
    rng = np.random.default_rng(9)
    half = n_pages // 2
    cmds = [Command.search(p, int(keys[p][rng.integers(len(keys[p]))]))
            for p in range(n_pages)]
    cmds += [Command.search(3, 0, 0), Command.search(5, 12345)]
    cmds += [Command.lookup(p, p + half, int(keys[p][-1 - p]))
             for p in range(half)]
    cmds.append(Command.lookup(0, half, 2**63 + 5))
    lo = int(np.sort(keys[2])[10])
    cmds += [Command.plan(p, exact_range(lo, lo + 2**50).include,
                          exact_range(lo + 1, lo + 2).include)
             for p in (2, 6, 7)]
    cmds += [Command.gather(p, int(rng.integers(0, 2**64, dtype=np.uint64)))
             for p in range(n_pages)]
    return cmds


def _same_response(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_response(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.gpu
def test_sharded_flush_on_card_matches_cpu():
    """A 4 x 4 sharded flush of every phase on the card equals the same
    flush with device="cpu" response by response and in its counters,
    with exactly one launch a phase."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(3)
    keys = [rng.integers(1, 2**62, 300, dtype=np.uint64) for _ in range(32)]
    results, stats = {}, {}
    for device in (dev, "cpu"):
        be = ShardedSsdBackend.from_geometry(
            channels=4, dies_per_channel=4, pages_per_chip=4, device_seed=5,
            timeline=True, device=device)
        for p, k in enumerate(keys):
            be.program_entries(p, k)
        tickets = [getattr(be, f"submit_{c.op.value}")(c)
                   for c in _sharded_burst(keys, 32)]
        before = dict(native.LAUNCHES)
        be.flush()
        torch.cuda.synchronize()
        grew = {k: native.LAUNCHES[k] - before[k] for k in before}
        if device == dev:
            assert grew == {"sim_search": 1, "sim_plan": 1, "sim_lookup": 1,
                            "sim_gather": 1, "sim_fused": 0,
                            "flash_attention": 0, "mamba_conv": 0,
                            "mamba_scan": 0}
        results[device] = [t.result() for t in tickets]
        stats[device] = (dataclasses.asdict(be.stats),
                         be.timeline.burst_latencies, be.timeline.energy_pj)
    assert stats[dev] == stats["cpu"] and stats[dev][0]["kernel_launches"] == 4
    for a, b in zip(results[dev], results["cpu"]):
        _same_response(a, b)


@pytest.mark.gpu
def test_sharded_replay_on_card_matches_cpu():
    """YCSB split and fused on 8 x 2 chips with the timeline: values,
    counters and the simulated latencies and energy equal the CPU run."""
    dev = _cuda_or_skip()
    wl = generate(400, n_key_pages=16, read_ratio=0.9, alpha=0.9, seed=5,
                  scan_ratio=0.05)
    for fused in (False, True):
        reps = [replay(wl, ShardedSsdBackend.from_geometry(
            channels=8, dies_per_channel=2, pages_per_chip=4, device_seed=2,
            timeline=True, device=device), RunConfig(burst=32, fused=fused))
            for device in (dev, "cpu")]
        card, cpu = reps
        for f in ("read_values", "read_hits", "scan_counts",
                  "burst_latencies_ns", "write_latencies_ns"):
            np.testing.assert_array_equal(getattr(card, f), getattr(cpu, f))
        for f in ("kernel_launches", "flushes", "staged_bytes",
                  "result_bytes", "sim_makespan_ns", "sim_energy_pj"):
            assert getattr(card, f) == getattr(cpu, f), f
        assert card.read_hits[wl.ops == 0].all()


@pytest.mark.gpu
def test_chip_axis_search_reprogram_between_flush_and_drain_on_card():
    """The chip-axis search reads the arena in place: a burst flushed
    before its page is reprogrammed, restaged and the arena grown resolves
    against the planes of its flush, as on the CPU."""
    dev = _cuda_or_skip()
    old = np.arange(1, 301, dtype=np.uint64) * 7
    new = np.arange(1, 301, dtype=np.uint64) * 11
    results = {}
    for device in (dev, "cpu"):
        be = ShardedSsdBackend.from_geometry(
            channels=4, dies_per_channel=4, pages_per_chip=4, device_seed=4,
            device=device)
        for p in range(48):
            be.program_entries(p, old + p)
        first = [be.submit_search(Command.search(p, int(old[9] + p)))
                 for p in (1, 2, 17)]
        be.flush()
        be.program_entries(1, new + 1)
        be.program_entries(17, new + 17)
        second = [be.submit_search(Command.search(p, int(old[9] + p)))
                  for p in (1, 17)]
        second += [be.submit_search(Command.search(p, 1)) for p in range(48)]
        be.flush()                             # restages rows; grows
        assert be.store.resident_rows == 48
        results[device] = [t.result() for t in first + second]
    card, cpu = results[dev], results["cpu"]
    assert [r.match_count for r in card[:5]] == [1, 1, 1, 0, 0]
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)


# ----------------------------------------- reliability and device faults
def _outcome(ticket):
    """A response, or the name and page of the typed error it raised."""
    try:
        return ticket.result()
    except (UncorrectableReadError, DegradedReadError) as e:
        return (type(e).__name__, e.page_addr)


def _same_outcome(a, b):
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert a == b
    else:
        _same_response(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["batched", "sharded"])
def test_reliable_flush_on_card_matches_cpu(name):
    """Fault-injected pages at age 90 (every open verdict occurs) with
    sense noise and 3-pass voting: a flush of every phase on the card
    equals the same flush with device="cpu" — responses and typed errors,
    ``ReliabilityStats``, backend counters — with one launch a phase."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(3)
    keys = [rng.integers(1, 2**62, 300, dtype=np.uint64) for _ in range(32)]
    results, stats = {}, {}
    for device in (dev, "cpu"):
        be = make_backend(name, SimChipArray(n_chips=16, pages_per_chip=4,
                                             device_seed=5), device=device)
        for p, k in enumerate(keys):
            be.program_entries(p, k)
        rel = ReliabilityState(ReliabilityPolicy(vote_k=3), FaultModel(
            seed=11, base_ber=1e-4, retention_days=90.0, sense_ber=2e-4))
        assert rel.install(be) > 0
        tickets = [getattr(be, f"submit_{c.op.value}")(c)
                   for c in _sharded_burst(keys, 32)]
        before = dict(native.LAUNCHES)
        be.flush()
        torch.cuda.synchronize()
        grew = {k: native.LAUNCHES[k] - before[k] for k in before}
        if device == dev:
            assert grew == {"sim_search": 1, "sim_plan": 1, "sim_lookup": 1,
                            "sim_gather": 1, "sim_fused": 0,
                            "flash_attention": 0, "mamba_conv": 0,
                            "mamba_scan": 0}
        results[device] = [_outcome(t) for t in tickets]
        stats[device] = (dataclasses.asdict(be.stats),
                         dataclasses.asdict(rel.stats))
    assert stats[dev] == stats["cpu"]
    verdicts = {r.search.open_verdict if hasattr(r, "search") else
                getattr(r, "open_verdict", None) for r in results["cpu"]
                if not isinstance(r, tuple)}
    assert any(isinstance(r, tuple) for r in results["cpu"])
    assert len(verdicts - {None}) >= 2
    for a, b in zip(results[dev], results["cpu"]):
        _same_outcome(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["batched", "sharded"])
def test_raw_bitmaps_of_damaged_then_repaired_page_on_card(name):
    """With no reliability tier the kernels return raw bitmaps: a search
    flushed before a page is damaged resolves against its flush's clean
    planes; one flushed after reads the damaged planes restaged in place,
    and one after the repair the clean planes again — each equal to the
    chip model's own search over the stored image at that point."""
    dev = _cuda_or_skip()
    keys = np.arange(1, 301, dtype=np.uint64) * 7
    be = make_backend(name, SimChipArray(n_chips=4, pages_per_chip=4,
                                         device_seed=2), device=dev)
    for p in range(8):
        be.program_entries(p, keys + p)
    # Low-bit-masked queries match many slots, so any flipped bit shows.
    cmds = [Command.search(p, int(keys[5] + p), 0xF) for p in range(8)]

    def flush():
        ts = [be.submit_search(c) for c in cmds]
        be.flush()
        return ts

    def host():
        return [be.chips.search(c).bitmap_words for c in cmds]

    clean = host()
    first = flush()                        # launched, not drained
    chip, local = be.chips.route(5)
    chip.inject_bit_errors(local, 400, rng=np.random.default_rng(1),
                           byte_region=(64, 4096))
    damaged = host()
    assert not np.array_equal(damaged[5], clean[5])
    second = flush()
    chip._repair(chip.pages[local], local)
    third = flush()
    for tickets, want in ((first, clean), (second, damaged),
                          (third, clean)):
        for t, w in zip(tickets, want):
            np.testing.assert_array_equal(t.result().bitmap_words, w)


@pytest.mark.gpu
def test_dead_chip_failover_on_card_matches_cpu():
    """Chip 0 dead from t = 0 with two replicas under the chaos preset on
    8 x 2 chips: the card's replay equals the CPU's (values, typed errors,
    fault counters, launches) and the healthy replay's values, and its
    failovers add launches over the replica rows to the healthy replay's."""
    dev = _cuda_or_skip()
    wl = generate(600, n_key_pages=32, read_ratio=0.8, alpha=0.9, seed=5)
    reps = {}
    for device, sched in ((dev, FaultSchedule.dead_chip(chip=0, seed=3)),
                          ("cpu", FaultSchedule.dead_chip(chip=0, seed=3)),
                          ("cpu", FaultSchedule.healthy(seed=3))):
        be = ShardedSsdBackend.from_geometry(
            channels=8, dies_per_channel=2, pages_per_chip=16,
            device_seed=2, replicas=2, device=device)
        before = dict(native.LAUNCHES)
        rep = replay(wl, be, RunConfig.chaos(sched, burst=32, fused=True,
                                             seed=3))
        launches = {k: native.LAUNCHES[k] - before[k] for k in before}
        reps[str(device), sched.outages != ()] = rep, launches
    (card, card_l), (cpu, _) = reps[str(dev), True], reps["cpu", True]
    healthy, _ = reps["cpu", False]
    for f in ("read_values", "read_hits"):
        np.testing.assert_array_equal(getattr(card, f), getattr(cpu, f))
        np.testing.assert_array_equal(getattr(card, f), getattr(healthy, f))
    assert dataclasses.asdict(card.faults).keys() \
        == dataclasses.asdict(cpu.faults).keys()
    for f in ("failovers", "degraded_ops", "remapped_blocks",
              "replica_programs", "n_op_errors", "timeouts"):
        assert getattr(card.faults, f) == getattr(cpu.faults, f), f
    np.testing.assert_array_equal(card.faults.op_errors, cpu.faults.op_errors)
    assert card.faults.failovers > 0 and card.faults.n_op_errors == 0
    assert card.kernel_launches == cpu.kernel_launches \
        == sum(card_l.values()) > healthy.kernel_launches


# ------------------------------------------------------ the contract auditor
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_launch_audit_clean_on_card(kind):
    """Both backends' launch audits are clean on the card (their SIM101
    holds ``native.LAUNCHES`` to one launch per recorded entry in every
    flush phase), and the four SiM kernels were launched."""
    _cuda_or_skip()
    log = []
    findings = audit_backend(kind, phase_log=log)
    assert findings == [], [f.format() for f in findings]
    seen = set()
    for ph in log:
        seen |= {k for k, v in ph.launches.items() if v}
    assert seen == {"sim_search", "sim_plan", "sim_lookup", "sim_gather"}


@pytest.mark.gpu
def test_conservation_audit_clean_on_card():
    _cuda_or_skip()
    findings = run_conservation()
    assert findings == [], [f.format() for f in findings]


@pytest.mark.gpu
def test_sync_debug_trip_on_card(monkeypatch):
    """A gather entry that reads a value back under sync debug mode is a
    SIM102 finding; the mode is back to its default afterwards."""
    _cuda_or_skip()
    orig = batched_mod.sim_gather

    def with_item(*args, **kwargs):
        out, counts = orig(*args, **kwargs)
        counts.sum().item()
        return out, counts

    monkeypatch.setattr(batched_mod, "sim_gather", with_item)
    findings = audit_backend("batched")
    assert ("SIM102", "gather", "host-sync:sim_gather") in \
        {(f.rule, f.symbol, f.slug) for f in findings}
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_double_launch_trips_sim101_on_card(monkeypatch):
    _cuda_or_skip()
    orig = sharded_mod.sim_search_chips

    def doubled(*args, **kwargs):
        first = orig(*args, **kwargs)
        orig(*args, **kwargs)
        return first

    monkeypatch.setattr(sharded_mod, "sim_search_chips", doubled)
    findings = audit_backend("sharded")
    bad = {f.symbol for f in findings
           if f.slug == "kernel-count:sim_search_chips"}
    assert bad >= {"search-cold", "search-warm"}


# The non-dense families and ring caches, reduced, in float32: arch ->
# config overrides.  Windowed configs keep an 8-slot ring (window 8).
FAMILIES = {"hymba-1.5b": {}, "mixtral-8x22b": {}, "kimi-k2-1t-a32b": {},
            "xlstm-350m": {}, "internvl2-26b": {}, "whisper-medium": {},
            "qwen3-4b": dict(sliding_window=8)}


def _family(arch, dev):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32", **FAMILIES[arch])
    model = init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n = {"vision_stub": cfg.frontend_tokens,
         "audio_stub": cfg.encoder_seq}.get(cfg.frontend)
    fe = None if n is None else torch.randn(2, n, cfg.d_model, device=dev,
                                            generator=gen)
    return cfg, model, fe


def _attention_layers(cfg, decode: bool) -> int:
    """flash_attention launches a prefill (decode step) makes: one a
    decoder layer; whisper adds a cross-attention a layer and, in prefill,
    an encoder layer each."""
    if cfg.family == "ssm":
        return 0
    if cfg.encoder_layers:
        return 2 * cfg.n_layers + (0 if decode else cfg.encoder_layers)
    return cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_families_on_card_kernel_matches_plain(arch):
    """Prefill of 11 tokens (past the 8-slot rings) and 6 decode steps
    (crossing the wrap; whisper's decode through cross-attention) through
    the kernel, teacher-forced against the same steps with the plain
    attention on the card: logits and caches within 1e-4, the kernel
    launched exactly once an attention."""
    from repro_torch.models.model import decode_step, prefill
    dev = _cuda_or_skip()
    cfg, model, fe = _family(arch, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 11), device=dev,
                           generator=gen)
    native.reset_launches()
    got, caches = prefill(model, tokens, 32, frontend_embeds=fe)
    assert native.LAUNCHES["flash_attention"] == _attention_layers(cfg, False)
    want, pcaches = prefill(model, tokens, 32, frontend_embeds=fe,
                            attention=plain_attention)
    for step in range(6):
        rel = float((got - want).norm() / want.norm())
        assert torch.isfinite(got[:, :cfg.vocab_size]).all() and rel < 1e-4
        tok = want.argmax(-1)[:, None]
        native.reset_launches()
        got, caches = decode_step(model, tok, caches, 11 + step,
                                  enc_out=caches.get("enc_out"))
        assert native.LAUNCHES["flash_attention"] == _attention_layers(
            cfg, True)
        want, pcaches = decode_step(model, tok, pcaches, 11 + step,
                                    enc_out=pcaches.get("enc_out"),
                                    attention=plain_attention)
    for a, b in zip(caches.get("kv", ()), pcaches.get("kv", ())):
        assert float((a - b).abs().max()) < 1e-4


@pytest.mark.gpu
def test_whisper_cross_attention_on_card_matches_plain():
    """Cross-attention decode (Sq = 1 over the encoder's frames, not
    causal, Sk not a multiple of the kernel's key steps) on the card."""
    from repro_torch.models.layers import apply_cross_attention
    dev = _cuda_or_skip()
    cfg, model, _ = _family("whisper-medium", dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 1, cfg.d_model, device=dev, generator=gen)
    enc = torch.randn(2, 37, cfg.d_model, device=dev, generator=gen)
    p = model.cross.layer(0)["attn"]
    with torch.no_grad():
        got = apply_cross_attention(p, x, enc)
        want = apply_cross_attention(p, x, enc, attention=plain_attention)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_train_step_on_card(arch):
    """One reduced train step a family on the card (remat block): the
    kernel launched twice an attention (forward and recompute), finite
    loss, and the step's loss and gradients within 1e-4 of the same step
    with the plain attention."""
    dev = _cuda_or_skip()
    cfg, model, fe = _family(arch, dev)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                      seed=0)
    batch = batch_at_step(data, 0, device=dev)
    if fe is not None:
        batch["frontend"] = fe
    opt_cfg = AdamWConfig(lr=1e-3)
    native.reset_launches()
    (loss, _), grads = value_and_grad(model, batch["tokens"],
                                      batch["labels"], frontend_embeds=fe,
                                      remat="block")
    assert native.LAUNCHES["flash_attention"] == 2 * _attention_layers(
        cfg, False)
    (ploss, _), pgrads = value_and_grad(model, batch["tokens"],
                                        batch["labels"], frontend_embeds=fe,
                                        remat="block",
                                        attention=plain_attention)
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(ploss)) < 1e-4
    for name, t in grads.items():
        ref = pgrads[name]
        assert torch.isfinite(t).all(), name
        assert float((t - ref).norm()) <= 1e-4 * max(float(ref.norm()),
                                                     1e-30), name
    state = init_opt_state(param_tree(model), opt_cfg)
    model, _, m = make_train_step(cfg, opt_cfg)(model, state, batch)
    assert np.isfinite(float(m["loss"]))


# ------------------------------------------ slice 11: the traceable kernel

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,kw", [
    (torch.bfloat16, (1, 1, 128, 32, 8, 128), dict(causal=True, q_offset=16)),
    (torch.bfloat16, (2, 64, 64, 4, 2, 64), dict(causal=True, window=16)),
    (torch.float32, (1, 40, 40, 4, 4, 32), dict(causal=False)),
])
def test_attention_op_is_its_launch_and_keeps_the_gradient(dtype, shape, kw):
    """The op ``repro_torch::flash_attention_fwd`` gives its body's launch
    bit for bit and counts one launch; through autograd the gradient is
    still the plain ``attend``'s VJP, bit for bit."""
    dev = _cuda_or_skip()
    from repro_torch.kernels.flash_attention import ops as flash_ops
    b, sq, sk, h, hkv, d = shape
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).to(dev, dtype) for s, n in ((sq, h), (sk, hkv),
                                                 (sk, hkv)))
    args = (q, k, v, kw["causal"], kw.get("window"), d ** -0.5,
            kw.get("q_offset", sk - sq))
    before = native.LAUNCHES["flash_attention"]
    got = torch.ops.repro_torch.flash_attention_fwd(*args)
    want = flash_ops.launch_kernel(*args)
    assert native.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, want)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    g = torch.ones(got.shape, device=dev, dtype=dtype)
    grads = torch.autograd.grad(flash_attention(*qkv, **kw), qkv, g)
    pq = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(plain_attention(*pq, **kw), pq, g)
    for a, p in zip(grads, plain):
        assert torch.equal(a, p)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["train", "decode", "prefill"])
def test_meta_trace_equals_the_card_run_of_a_reduced_step(mode):
    """A reduced olmo-1b step traced on meta tensors and run on the card
    under the same counter: every count equal, the attention launched
    as counted, and the traced peak equal to the run's live storages."""
    dev = _cuda_or_skip()
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.trace_analysis import count
    from repro_torch.models.config import InputShape
    cfg = reduced_config(get_config("olmo-1b"))
    shape = InputShape("t", mode, 32, 4)
    cell = build_step(cfg, shape)
    _, traced = count(cell.step, *cell.inputs, device_type="meta")
    cell = build_step(cfg, shape, device=dev)
    cell.inputs[0].reset_parameters(
        torch.Generator(device=dev).manual_seed(0))
    native.reset_launches()
    _, ran = count(cell.step, *cell.inputs, device_type="cuda")
    torch.cuda.synchronize()
    assert ran.key() == traced.key()
    assert ran.peak_bytes == traced.peak_bytes
    assert native.LAUNCHES["flash_attention"] == cfg.n_layers * (
        2 if mode == "train" else 1)


@pytest.mark.gpu
def test_examples_on_card_equal_their_cpu_runs():
    """``range_query_analytics.main()`` equals its CPU run number for number
    with one ``sim_plan`` and one ``sim_gather`` launch a select;
    ``serve_lm.main()`` completes every request with the CPU run's counts."""
    _cuda_or_skip()
    from repro_torch import range_query_analytics, serve_lm
    native.reset_launches()
    card = range_query_analytics.main()
    assert (native.LAUNCHES["sim_plan"], native.LAUNCHES["sim_gather"]) == \
        (3, 3) and sum(native.LAUNCHES.values()) == 6
    assert card == range_query_analytics.main(device="cpu")
    card = serve_lm.main([])
    cpu = serve_lm.main(["--device", "cpu"])
    assert {c.req_id: len(c.tokens) for c in card["completions"]} == \
        {c.req_id: len(c.tokens) for c in cpu["completions"]}
    assert (card["tokens"], card["searches"]) == (cpu["tokens"],
                                                  cpu["searches"])
    assert len(card["completions"]) == 12


# ------------------------------ slice 12: the tensor-parallel training step

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_world_of_one_nccl_tp_step_equals_the_plain_step():
    """The sharded step on a (1, 1) mesh over NCCL (its collectives run,
    over groups of one) equals the plain one-device step: reduced olmo-1b
    in float32, two steps, loss within 1e-5 and parameters within 1e-4;
    the kernel launched twice a layer a step in both."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    dev = _cuda_or_skip()
    assert not dist.is_initialized()
    cfg = dataclasses.replace(reduced_config(get_config("olmo-1b")),
                              dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                      seed=0)
    step = make_train_step(cfg, opt_cfg)
    plain = init_model(cfg, seed=0, device=dev)
    state = init_opt_state(param_tree(plain), opt_cfg)
    native.reset_launches()
    for i in range(2):
        plain, state, m = step(plain, state, batch_at_step(data, i,
                                                           device=dev))
    assert native.LAUNCHES["flash_attention"] == 2 * 2 * cfg.n_layers
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        model = init_model(cfg, seed=0, device=dev)
        shard_model(model, mesh, fsdp=cfg.fsdp)
        ostate = init_opt_state(param_tree(model), opt_cfg)
        native.reset_launches()
        for i in range(2):
            batch = {k: distribute(v, mesh, batch_sharding(mesh))
                     for k, v in batch_at_step(data, i, device=dev).items()}
            model, ostate, ms = step(model, ostate, batch)
        torch.cuda.synchronize()
        assert native.LAUNCHES["flash_attention"] == 2 * 2 * cfg.n_layers
        assert abs(float(ms["loss"]) - float(m["loss"])) < 1e-5
        for (n, p), q in zip(model.named_parameters(), plain.parameters()):
            assert float((p.full_tensor() - q).abs().max()) < 1e-4, n
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_world_of_one_nccl_pod_stage_is_bitwise_the_stacked_stage():
    """The compressed step's cross-pod stage (``compress_over_pods``) on a
    (1, 1, 1) ``("pod", "data", "model")`` mesh over NCCL, its MAX and sum
    all-reduces run over groups of one, equals ``compress_stacked`` with
    one pod bit for bit: the mean and the residual of seeded leaves."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import (compress_over_pods,
                                                  compress_stacked,
                                                  error_state_placements)
    from repro_torch.parallel.sharding import distribute
    dev = _cuda_or_skip()
    assert not dist.is_initialized()
    gen = torch.Generator(device="cpu").manual_seed(3)
    shapes = {"split": ((64, 48), Shard(1)), "whole": ((33, 7), Replicate())}
    g = {k: torch.randn(s, generator=gen).to(dev) for k, (s, _) in
         shapes.items()}
    e = {k: (torch.randn((1,) + s, generator=gen) * 1e-3).to(dev)
         for k, (s, _) in shapes.items()}
    want = {k: compress_stacked(g[k][None], e[k]) for k in shapes}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        grads = {k: distribute(g[k], mesh, (Replicate(), Replicate(), pl))
                 for k, (_, pl) in shapes.items()}
        pl = error_state_placements(grads, mesh)
        errs = {k: distribute(e[k], mesh, pl[k]) for k in shapes}
        mean, new = compress_over_pods(grads, errs, mesh)
        for k in shapes:
            assert torch.equal(mean[k].full_tensor(), want[k][0]), k
            assert torch.equal(new[k].full_tensor(), want[k][1]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h_local", [1, 2])
def test_attention_kernel_at_local_head_counts(dtype, h_local):
    """The kernel at a model-axis rank's head counts: ``h_local`` q heads
    over the one kv head they read (qwen3-4b's 32 q over 8 kv heads on a
    16-way axis gives 2 over 1; olmo-1b's 16 heads give 1 over 1), causal
    and windowed, against the plain version at the file's tolerances."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(h_local)
    q = torch.randn(2, 96, h_local, 128, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(2, 96, 1, 128, device=dev, generator=g).to(dtype)
            for _ in range(2))
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    for kw in (dict(causal=True), dict(causal=True, window=32)):
        before = native.LAUNCHES["flash_attention"]
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert native.LAUNCHES["flash_attention"] == before + 1
        want = attention_ref(q, k, v, **kw)
        assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.gpu
def test_reduced_mixtral_resume_is_bitwise_on_card(tmp_path, monkeypatch):
    """Reduced mixtral-8x22b (bf16, remat block) trained 4 steps straight
    and crashed at step 3 then restarted from the step-2 checkpoint, under
    ``torch.use_deterministic_algorithms``: the last two losses equal bit
    for bit on the card (the MoE's routing, dispatch and combine included)."""
    from repro_torch.launch.train import train
    dev = _cuda_or_skip()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(steps=4, batch=4, seq_len=32, ckpt_every=2, verbose=False,
                  device=dev)
        straight = train("mixtral-8x22b", ckpt_root=tmp_path / "a", **kw)
        with pytest.raises(RuntimeError):
            train("mixtral-8x22b", ckpt_root=tmp_path / "b", crash_at=3,
                  **kw)
        again = train("mixtral-8x22b", ckpt_root=tmp_path / "b", **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert again.resumed_from == 2
    assert again.losses == straight.losses[2:]
    assert all(np.isfinite(straight.losses))


# -------------------------------------- slice 13: the sharded serve step

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,kw", [
    # the serve path's decode, split in the block over its 4 key steps
    (torch.bfloat16, (1, 1, 128, 32, 8, 128), dict(causal=True, q_offset=16)),
    # one key step: the warp writes from registers
    (torch.bfloat16, (1, 1, 20, 4, 2, 64), dict(causal=True, q_offset=19)),
    (torch.float32, (2, 1, 16, 4, 2, 32), dict(causal=True, q_offset=9)),
    # hymba's ring decode, 5 kv heads of group 5
    (torch.bfloat16, (1, 1, 1024, 25, 5, 64), dict(causal=True, q_offset=300)),
    (torch.float32, (1, 1, 1024, 25, 5, 64), dict(causal=True,
                                                   q_offset=1023)),
    # rank 0 of qwen3-4b decode_32k on 16 x 16: its 2,048-slot slice, all
    # seen, half seen, none seen
    (torch.bfloat16, (8, 1, 2048, 32, 8, 128), dict(causal=True,
                                                     q_offset=32767)),
    (torch.bfloat16, (8, 1, 2048, 32, 8, 128), dict(causal=True,
                                                     q_offset=1023)),
    (torch.bfloat16, (8, 1, 2048, 32, 8, 128), dict(causal=True,
                                                     q_offset=-1)),
    # many rows: row tiles of 64 with one split, and a window
    (torch.bfloat16, (4, 256, 256, 16, 16, 128), dict(causal=True)),
    (torch.float32, (2, 64, 64, 4, 2, 64), dict(causal=True, window=16)),
])
def test_kernel_log_sum_exp_matches_plain(dtype, shape, kw):
    """``flash_attention(return_lse=True)`` on the card: one launch, the
    output bit for bit the launch without the log-sum-exp and within the
    file's tolerance of ``attention_ref``, the log-sum-exp within 1e-5
    (absolute and relative) of ``attention_ref``'s, NEG_INF (-1e30) exactly
    for a row that sees no key."""
    dev = _cuda_or_skip()
    b, sq, sk, h, hkv, d = shape
    g = torch.Generator(device=dev).manual_seed(sk + h)
    q = torch.randn(b, sq, h, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, sk, hkv, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    before = native.LAUNCHES["flash_attention"]
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == before + 1
    assert lse.shape == (b, sq, h) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    p_out, p_lse = attention_ref(q, k, v, return_lse=True, **kw)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    assert float((out.float() - p_out.float()).abs().max()) < tol
    empty = p_lse <= -1e29
    assert torch.equal(lse[empty], p_lse[empty])
    assert ((lse - p_lse).abs() <= 1e-5 + 1e-5 * p_lse.abs()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "hymba-1.5b", "xlstm-350m"])
def test_sharded_decode_cell_of_a_fake_world_traced_equals_its_run(arch):
    """Rank 0 of a (2, 2) ``fake`` world: a reduced decode cell's sharded
    step (``dryrun.build_step``, caches in the JAX layout) traced on meta
    tensors and run on the card under the same counter: every count and
    the peak equal, the kernel launched once a layer (none for xlstm)."""
    dev = _cuda_or_skip()
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.dryrun import build_step, fake_world
    from repro_torch.launch.trace_analysis import count
    from repro_torch.models.config import InputShape
    cfg = reduced_config(get_config(arch))
    shape = InputShape("t", "decode", 32, 4)
    with fake_world(4):
        mesh = DeviceMesh("cuda", torch.arange(4).view(2, 2),
                          mesh_dim_names=("data", "model"))
        cell = build_step(cfg, shape, mesh)
        _, traced = count(cell.step, *cell.inputs, device_type="meta")
        cell = build_step(cfg, shape, mesh, device=dev)
        native.reset_launches()
        _, ran = count(cell.step, *cell.inputs, device_type="cuda")
        torch.cuda.synchronize()
    assert ran.key() == traced.key()
    assert ran.peak_bytes == traced.peak_bytes
    assert native.LAUNCHES["flash_attention"] == (
        0 if cfg.family == "ssm" else cfg.n_layers)
    assert traced.collective_bytes["all-gather"] > 0


# ------------------------------------------ the mamba heads' two kernels

def _mamba_inputs(dev, dtype, b, s, e=3200, n=16, k=4, proj_dtype=None,
                  seed=0):
    """hymba-1.5b-base's widths (e 3,200, N 16, K 4): xz, a nonzero conv
    tail, conv_w, proj, a_log, d_skip and a nonzero state on the card."""
    g = torch.Generator(device=dev).manual_seed(seed + 7 * s + b)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dt)
    return dict(xz=randn(b, s, 2 * e, dt=dtype),
                conv_tail=randn(b, k - 1, e, dt=dtype),
                conv_w=randn(k, e, scale=0.5, dt=dtype),
                proj=randn(b, s, 2 * n + 1, dt=proj_dtype or dtype),
                a_log=randn(e, n, scale=0.5), d_skip=randn(e),
                state=randn(b, e, n))


def _bf16_ulps(got, want):
    """Each bf16 output's distance from the plain version's, in ulps of the
    plain value (2^(e - 8) for a value of binade 2^(e - 1))."""
    got, want = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    return (got - want).abs() / ulp.clamp_min(2.0 ** -133)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,proj_f32", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
@pytest.mark.parametrize("s", [1, 16, 17, 1024])
@pytest.mark.parametrize("b", [1, 2])
def test_mamba_kernels_match_plain(b, s, dtype, proj_f32):
    """``mamba_conv`` and ``mamba_scan`` on the card against ``ref.py`` on
    the card, one launch each: the conv's output and new tail bit for bit;
    the final state within 1e-5 relative (the updates round as the plain
    version's do); the scan's output in float32 within 1e-5 relative, in
    bf16 at least 99.9 % bit for bit and the rest within 3 ulps or, where
    the sum cancels to near 0, within 1e-6 of the largest output: the
    c . h sum runs in another order, so y may round to bf16 one ulp apart,
    which the product with silu(z) scales and rounds again.  proj in
    float32 is the sharded step's (summed over ranks)."""
    from repro_torch.kernels.mamba_scan.ops import mamba_conv, mamba_scan
    from repro_torch.kernels.mamba_scan.ref import (causal_conv_ref,
                                                   selective_scan_ref)
    dev = _cuda_or_skip()
    c = _mamba_inputs(dev, dtype, b, s,
                      proj_dtype=torch.float32 if proj_f32 else None)
    e = c["conv_w"].shape[1]
    u_ref, tail_ref = causal_conv_ref(c["xz"][..., :e], c["conv_tail"],
                                      c["conv_w"])
    y_ref, h_ref = selective_scan_ref(u_ref, c["xz"][..., e:],
                                      c["proj"].float(), c["a_log"],
                                      c["d_skip"], c["state"])
    tail, state = c["conv_tail"].clone(), c["state"].clone()
    before = dict(native.LAUNCHES)
    u, _ = mamba_conv(c["xz"], tail, c["conv_w"])
    y, _ = mamba_scan(c["xz"], u, c["proj"], c["a_log"], c["d_skip"], state)
    torch.cuda.synchronize()
    assert native.LAUNCHES["mamba_conv"] == before["mamba_conv"] + 1
    assert native.LAUNCHES["mamba_scan"] == before["mamba_scan"] + 1
    assert torch.equal(u, u_ref) and torch.equal(tail, tail_ref)
    assert float((state - h_ref).norm() / h_ref.norm()) < 1e-5
    if dtype == torch.bfloat16:
        ulps = _bf16_ulps(y, y_ref)
        near = (y.float() - y_ref.float()).abs() <= \
            1e-6 * y_ref.float().abs().max()
        exact = float((ulps == 0).float().mean())
        assert exact >= 0.999, exact
        assert bool(((ulps <= 3) | near).all()), float(ulps[~near].max())
    else:
        assert float((y - y_ref).norm() / y_ref.norm()) < 1e-5


@pytest.mark.gpu
def test_mamba_kernels_write_the_caches_in_place():
    """Handed a layer's views of the serving caches ((L, B, ...) tensors),
    the kernels write that layer's new tail and state there and touch no
    other layer; ``apply_mamba`` returns the views themselves, so its
    callers copy nothing back."""
    from repro_torch.kernels.mamba_scan.ops import mamba_conv, mamba_scan
    from repro_torch.kernels.mamba_scan.ref import (causal_conv_ref,
                                                   selective_scan_ref)
    from repro_torch.models import ssm
    dev = _cuda_or_skip()
    c = _mamba_inputs(dev, torch.bfloat16, 2, 5)
    e = c["conv_w"].shape[1]
    tails = torch.stack([c["conv_tail"] * (i + 1) for i in range(3)])
    states = torch.stack([c["state"] * (i + 1) for i in range(3)])
    keep_t, keep_s = tails.clone(), states.clone()
    u, held_t = mamba_conv(c["xz"], tails[1], c["conv_w"])
    y, held_s = mamba_scan(c["xz"], u, c["proj"], c["a_log"], c["d_skip"],
                           states[1])
    torch.cuda.synchronize()
    u_ref, tail_ref = causal_conv_ref(c["xz"][..., :e], keep_t[1],
                                      c["conv_w"])
    _, h_ref = selective_scan_ref(u_ref, c["xz"][..., e:], c["proj"].float(),
                                  c["a_log"], c["d_skip"], keep_s[1])
    assert held_t.data_ptr() == tails[1].data_ptr()
    assert held_s.data_ptr() == states[1].data_ptr()
    assert torch.equal(tails[1], tail_ref)
    assert float((states[1] - h_ref).norm() / h_ref.norm()) < 1e-5
    for i in (0, 2):
        assert torch.equal(tails[i], keep_t[i])
        assert torch.equal(states[i], keep_s[i])
    cfg = reduced_config(get_config("hymba-1.5b-base"))
    model = init_model(cfg, seed=0, device=dev)
    p = model.blocks.layer(0)["mamba"]
    dt = p["in_proj"].dtype
    views = (torch.zeros(2, cfg.mamba_width, cfg.ssm_state, device=dev),
             torch.zeros(2, cfg.ssm_conv - 1, cfg.mamba_width, device=dev,
                         dtype=dt))
    x = torch.randn(2, 3, cfg.d_model, device=dev).to(dt)
    with torch.no_grad():
        _, new = ssm.apply_mamba(p, x, cfg, state=views[0],
                                 conv_state=views[1])
    assert new[0] is views[0] and new[1] is views[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_base_served_on_card_matches_cpu(dtype):
    """A reduced hymba-1.5b-base served on the card and on the CPU with the
    same weights: the same token counts, and in float32 every request's
    first logits within 1e-4 relative; on the card every serving mamba
    call ran the two kernels, a launch each a layer of every prefill and
    decode step, and on the CPU none."""
    import simbench.systems.lm as lm_system
    from simbench.yardstick.kinds.serve import draw_weights
    dev = _cuda_or_skip()
    cfg = dataclasses.replace(reduced_config(get_config("hymba-1.5b-base")),
                              dtype=dtype)
    conf = dataclasses.asdict(cfg)
    conf["global_layers"] = list(cfg.global_layers)
    conf["kv_groups"] = [list(g) for g in cfg.kv_groups]
    weights = draw_weights(conf, 3, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (19, 5, 12)]
    runs = {}
    for device in (dev, torch.device("cpu")):
        from repro_torch.models.model import LM
        from repro_torch.serve.batching import Request
        model = LM(cfg, device)
        with torch.no_grad():
            lm_system.load_weights(model, weights)
        seen = {}
        cache = SimPagedKVCache(cfg, n_pages=64, page_tokens=4,
                                device=device)
        engine = ServeEngine(
            model, max_slots=2, cache_len=64, paged_cache=cache,
            on_token=lambda r, t, lg: seen.setdefault(r, []).append(
                lg[0, :cfg.vocab_size].float().cpu()))
        before = dict(native.LAUNCHES)
        for rid, prompt in enumerate(prompts):
            engine.submit(Request(req_id=rid, prompt=prompt,
                                  max_new_tokens=10 + rid))
        engine.run()
        runs[device.type] = (engine, seen, {
            k: native.LAUNCHES[k] - before[k]
            for k in ("mamba_conv", "mamba_scan")})
    (card, card_seen, launched), (cpu, cpu_seen, none) = (runs["cuda"],
                                                          runs["cpu"])
    steps = cfg.n_layers * (card.prefills + card.decodes)
    assert launched == {"mamba_conv": steps, "mamba_scan": steps}
    assert steps > 0 and none == {"mamba_conv": 0, "mamba_scan": 0}
    assert [len(c.tokens) for c in card.completed] == [
        len(c.tokens) for c in cpu.completed]
    if dtype == "float32":
        for rid in cpu_seen:
            got, want = card_seen[rid][0], cpu_seen[rid][0]
            assert float((got - want).norm() / want.norm()) < 1e-4
